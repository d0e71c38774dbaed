// Fused 2-layer tanh MLP field and its fused pullback, for Hopper (sm_90a).
//
//   h = tanh(x W0 + b0),  y = h W1 + b1          x: (B, din), W0: (din, hid),
//                                               W1: (hid, dout), row-major
//   dW1 = h^T g,  db1 = sum_b g,  dz = (g W1^T) * (1 - h*h),
//   db0 = sum_b dz,  dW0 = x^T dz,  dx = dz W0^T
//
// Dtype rules of the TPU kernels (pallas_mlp.py:46-89): products accumulate
// in float64 for float64 data and in float32 for float32 and bfloat16 data
// (float32 is exact float32, never TF32); h is stored in the data type and
// the second product reads that rounded h; dz is rounded to the data type
// before dW0 and dx, while db0 sums the unrounded dz.
//
// K3 mlp2_fwd_<t> replaces the Pallas kernel
//    scimlsensitivity_jl_tpu/ops/pallas_mlp.py:_fwd_kernel (via
//    _fused_fwd_call). Two tiled products from one entry point: x W0 with a
//    bias + tanh epilogue that stores h, then h W1 with a bias epilogue.
//    The TPU kernel holds all of h in VMEM; a Hopper block holds at most
//    227 KB, and B = 1024 rows of h at hid = 2048 is 4 MB, so h makes one
//    round trip through device memory (L2 holds it: 50 MB).
// K4 mlp2_bwd_<t> replaces scimlsensitivity_jl_tpu/ops/pallas_mlp.py:
//    _bwd_kernel (via _fused_bwd). The TPU kernel is one sequential
//    program; here dz must exist in full before dW0 and dx, so the entry
//    point runs six passes in order on the caller's stream: dW1, db1, dz
//    (g W1^T with the (1 - h^2) epilogue), db0, dW0, dx.
//
// What bounds them on an H100: at the batched field's shape (B = 1024,
// 512 -> 2048 -> 512, bfloat16) K3 does 4 B din hid = 4.29 GFLOP on
// 10.5 MB, 4.3 us at the 989 TFLOP/s bf16 tensor-core peak against 3.1 us
// of HBM time: arithmetic bounds it, and K4 (8.59 GFLOP) likewise. What the
// design does about it: bfloat16 products run on the tensor cores (WMMA
// 16x16x16 fragments, float32 accumulation) over 64x64 tiles staged in
// shared memory with 16-byte loads, the next depth slice prefetched into
// registers; float32 and float64 products, which must not round to
// TF32, run on the CUDA cores as a 64x64 tile per block of 256 threads, 4x4
// outputs per thread. The spiral's 2 -> 50 -> 2 field at B = 1 is bound by
// the launches alone. Making the tensor-core path fast (TMA, wgmma,
// pipelining) is later work; these kernels are simple and right first.
//
// Transposed operands (h^T, x^T, W1^T, W0^T) are read from their row-major
// storage by their own tile-load index maps (CUDA cores) or tile layouts
// and column-major fragments (tensor cores), so neighbouring threads read
// neighbouring addresses in either layout. Ragged edges are masked at the
// loads (zero fill) and at the stores.
//
// Determinism: every output element is one thread's (or one WMMA tile's)
// sum over K in a fixed order, and the column sums db0, db1 reduce in a
// fixed tree; there are no atomics and no split-K, so two calls return the
// same bits. Every launcher uses the caller's stream, never synchronises,
// allocates nothing (the wrapper passes dz scratch), and returns
// cudaGetLastError().

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;

template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<double> { using type = double; };
template <typename T> using acc_t = typename AccOf<T>::type;

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ double to_acc(double v) { return v; }
__device__ __forceinline__ float to_acc(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(double* p, double v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even
}

__device__ __forceinline__ float acc_tanh(float v) { return tanhf(v); }
__device__ __forceinline__ double acc_tanh(double v) { return tanh(v); }

// uncontracted multiply and subtract: dz rounds as the plain version does
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// -- epilogues: called once per output element with the accumulated sum ----

template <typename T>
struct EpiBiasTanh {  // h = tanh(v + b0)
  const T* bias;
  T* out;
  int64_t ld;
  __device__ void operator()(int64_t m, int64_t n, acc_t<T> v) const {
    store(out + m * ld + n, acc_tanh(v + to_acc(bias[n])));
  }
};

template <typename T>
struct EpiBias {  // y = v + b1
  const T* bias;
  T* out;
  int64_t ld;
  __device__ void operator()(int64_t m, int64_t n, acc_t<T> v) const {
    store(out + m * ld + n, v + to_acc(bias[n]));
  }
};

template <typename T>
struct EpiStore {  // dW1, dW0, dx
  T* out;
  int64_t ld;
  __device__ void operator()(int64_t m, int64_t n, acc_t<T> v) const {
    store(out + m * ld + n, v);
  }
};

template <typename T>
struct EpiDz {  // dz = dh * (1 - h*h), kept unrounded and rounded to T
  const T* h;
  acc_t<T>* dz;
  T* dzc;
  int64_t ld;
  __device__ void operator()(int64_t m, int64_t n, acc_t<T> v) const {
    const int64_t i = m * ld + n;
    const acc_t<T> hv = to_acc(h[i]);
    const acc_t<T> d = mul_rn(v, sub_rn(acc_t<T>(1), mul_rn(hv, hv)));
    dz[i] = d;
    store(dzc + i, d);
  }
};

// Element (m, k) of op(A) and (k, n) of op(B), read from row-major storage:
// A is (M, K) with leading dimension lda, or (K, M) when TA; B is (K, N),
// or (N, K) when TB.
template <bool TA, typename T>
__device__ __forceinline__ const T* a_at(const T* A, int64_t m, int64_t k,
                                         int64_t lda) {
  return TA ? A + k * lda + m : A + m * lda + k;
}
template <bool TB, typename T>
__device__ __forceinline__ const T* b_at(const T* B, int64_t k, int64_t n,
                                         int64_t ldb) {
  return TB ? B + n * ldb + k : B + k * ldb + n;
}

// -- CUDA-core tiled product (float32, float64) -------------------------------

constexpr int kBM = 64, kBN = 64, kBK = 16;
constexpr int kThreads = 256;  // 16 x 16, each thread 4 x 4 outputs

template <typename T, bool TA, bool TB, typename Epi>
__global__ void __launch_bounds__(kThreads)
gemm_simt_kernel(const T* __restrict__ A, const T* __restrict__ B, int64_t M,
                 int64_t N, int64_t K, int64_t lda, int64_t ldb, Epi epi) {
  using Acc = acc_t<T>;
  __shared__ Acc As[kBK][kBM + 1];
  __shared__ Acc Bs[kBK][kBN + 1];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * kBM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kBN;
  Acc acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = Acc(0);

  for (int64_t k0 = 0; k0 < K; k0 += kBK) {
    // each tile is 1024 elements, 4 per thread; the index map follows the
    // storage so that neighbouring threads read neighbouring addresses
#pragma unroll
    for (int r = 0; r < (kBM * kBK) / kThreads; ++r) {
      const int e = threadIdx.x + r * kThreads;
      const int mm = TA ? e % kBM : e / kBK;
      const int kk = TA ? e / kBM : e % kBK;
      const int64_t gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < K) ? to_acc(*a_at<TA>(A, gm, gk, lda)) : Acc(0);
    }
#pragma unroll
    for (int r = 0; r < (kBN * kBK) / kThreads; ++r) {
      const int e = threadIdx.x + r * kThreads;
      const int nn = TB ? e / kBK : e % kBN;
      const int kk = TB ? e % kBK : e / kBN;
      const int64_t gn = n0 + nn, gk = k0 + kk;
      Bs[kk][nn] = (gn < N && gk < K) ? to_acc(*b_at<TB>(B, gk, gn, ldb)) : Acc(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      Acc a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t gm = m0 + ty + 16 * i, gn = n0 + tx + 16 * j;
      if (gm < M && gn < N) epi(gm, gn, acc[i][j]);
    }
}

// -- tensor-core tiled product (bfloat16 data, float32 accumulation) ---------
//
// Each shared tile keeps the layout of its operand's storage, so every
// thread moves whole 16-byte chunks (8 values) from device memory, and a
// transposed operand is read by a column-major fragment instead of being
// transposed on the way in. The next depth slice is loaded into registers
// while the tensor cores work on the current one.

constexpr int kWK = 32;          // depth of a shared tile
constexpr int kWThreads = 128;   // 4 warps, each a 32 x 32 quarter of 64 x 64
constexpr int kCld = kBN + 4;    // padded leading dimension of the C tile
constexpr int kPad = 8;          // row padding (elements): rows stay 16-byte aligned

// A tile of `R` rows whose `C` values each lie contiguous in storage, with
// row r0 + r and column c0 + c at G[(r0 + r) * ld + c0 + c]. Chunk `i`
// (of R * C / 8) is 8 values of one row.
template <int R, int C>
struct Tile {
  static constexpr int kChunks = R * C / 8;
  static constexpr int kPerThread = kChunks / kWThreads;
  __device__ static uint4 load(const bf16* G, int64_t ld, int64_t r0,
                               int64_t c0, int64_t rows, int64_t cols, int i,
                               bool vec) {
    const int r = i / (C / 8), c = (i % (C / 8)) * 8;
    const int64_t gr = r0 + r, gc = c0 + c;
    if (vec && gr < rows && gc + 8 <= cols)
      return *reinterpret_cast<const uint4*>(G + gr * ld + gc);
    union { uint4 v; unsigned short e[8]; } out;  // zero fill at the edge
#pragma unroll
    for (int e = 0; e < 8; ++e)
      out.e[e] = (gr < rows && gc + e < cols)
                     ? __bfloat16_as_ushort(G[gr * ld + gc + e]) : 0;
    return out.v;
  }
  __device__ static void store(bf16 (*S)[C + kPad], int i, uint4 v) {
    const int r = i / (C / 8), c = (i % (C / 8)) * 8;
    *reinterpret_cast<uint4*>(&S[r][c]) = v;
  }
};

template <bool TA, bool TB, typename Epi>
__global__ void __launch_bounds__(kWThreads)
gemm_wmma_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                 int64_t M, int64_t N, int64_t K, int64_t lda, int64_t ldb,
                 bool vec_a, bool vec_b, Epi epi) {
  using namespace nvcuda;
  // storage layouts: A is (m, k) or, when TA, (k, m); B is (k, n) or, when
  // TB, (n, k); the contiguous index is the second
  constexpr int AR = TA ? kWK : kBM, AC = TA ? kBM : kWK;
  constexpr int BR = TB ? kBN : kWK, BC = TB ? kWK : kBN;
  using TileA = Tile<AR, AC>;
  using TileB = Tile<BR, BC>;
  using LayoutA = typename std::conditional<TA, wmma::col_major,
                                            wmma::row_major>::type;
  using LayoutB = typename std::conditional<TB, wmma::col_major,
                                            wmma::row_major>::type;
  __shared__ __align__(32) bf16 As[AR][AC + kPad];
  __shared__ __align__(32) bf16 Bs[BR][BC + kPad];
  __shared__ __align__(32) float Cs[kBM][kCld];
  const int warp = threadIdx.x / 32;
  const int wr = (warp / 2) * 32, wc = (warp % 2) * 32;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * kBM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kBN;
  // (row, column) origin and extent of each tile in its storage
  auto a_origin = [&](int64_t k0, int64_t& r0, int64_t& c0) {
    r0 = TA ? k0 : m0;
    c0 = TA ? m0 : k0;
  };
  auto b_origin = [&](int64_t k0, int64_t& r0, int64_t& c0) {
    r0 = TB ? n0 : k0;
    c0 = TB ? k0 : n0;
  };
  const int64_t a_rows = TA ? K : M, a_cols = TA ? M : K;
  const int64_t b_rows = TB ? N : K, b_cols = TB ? K : N;

  uint4 ra[TileA::kPerThread], rb[TileB::kPerThread];
  auto fetch = [&](int64_t k0) {
    int64_t r0, c0;
    a_origin(k0, r0, c0);
#pragma unroll
    for (int j = 0; j < TileA::kPerThread; ++j)
      ra[j] = TileA::load(A, lda, r0, c0, a_rows, a_cols,
                          threadIdx.x + j * kWThreads, vec_a);
    b_origin(k0, r0, c0);
#pragma unroll
    for (int j = 0; j < TileB::kPerThread; ++j)
      rb[j] = TileB::load(B, ldb, r0, c0, b_rows, b_cols,
                          threadIdx.x + j * kWThreads, vec_b);
  };
  auto stage = [&]() {
#pragma unroll
    for (int j = 0; j < TileA::kPerThread; ++j)
      TileA::store(As, threadIdx.x + j * kWThreads, ra[j]);
#pragma unroll
    for (int j = 0; j < TileB::kPerThread; ++j)
      TileB::store(Bs, threadIdx.x + j * kWThreads, rb[j]);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.0f);

  fetch(0);
  stage();
  __syncthreads();
  for (int64_t k0 = 0; k0 < K; k0 += kWK) {
    const bool more = k0 + kWK < K;
    if (more) fetch(k0 + kWK);  // in flight while the tensor cores work
#pragma unroll
    for (int kk = 0; kk < kWK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LayoutA> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LayoutB> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const bf16* pa = TA ? &As[kk][wr + 16 * i] : &As[wr + 16 * i][kk];
        wmma::load_matrix_sync(a[i], pa, AC + kPad);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bf16* pb = TB ? &Bs[wc + 16 * j][kk] : &Bs[kk][wc + 16 * j];
        wmma::load_matrix_sync(b[j], pb, BC + kPad);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
    }
    __syncthreads();
    if (more) {
      stage();
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wr + 16 * i][wc + 16 * j], c[i][j], kCld,
                              wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < kBM * kBN; e += kWThreads) {
    const int mm = e / kBN, nn = e % kBN;
    const int64_t gm = m0 + mm, gn = n0 + nn;
    if (gm < M && gn < N) epi(gm, gn, Cs[mm][nn]);
  }
}

// -- launch: the route follows the data type ----------------------------------

inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

inline bool grid_fits(int64_t M, int64_t N) {
  return cdiv(M, kBM) <= 65535 && cdiv(N, kBN) <= 2147483647;
}

template <typename T>
struct Gemm {  // float32, float64: CUDA cores
  template <bool TA, bool TB, typename Epi>
  static cudaError_t run(const T* A, const T* B, int64_t M, int64_t N,
                         int64_t K, int64_t lda, int64_t ldb, Epi epi,
                         cudaStream_t s) {
    if (!grid_fits(M, N)) return cudaErrorInvalidConfiguration;
    const dim3 grid(static_cast<unsigned>(cdiv(N, kBN)),
                    static_cast<unsigned>(cdiv(M, kBM)));
    gemm_simt_kernel<T, TA, TB, Epi><<<grid, kThreads, 0, s>>>(
        A, B, M, N, K, lda, ldb, epi);
    return cudaGetLastError();
  }
};

template <>
struct Gemm<bf16> {  // bfloat16: tensor cores
  template <bool TA, bool TB, typename Epi>
  static cudaError_t run(const bf16* A, const bf16* B, int64_t M, int64_t N,
                         int64_t K, int64_t lda, int64_t ldb, Epi epi,
                         cudaStream_t s) {
    if (!grid_fits(M, N)) return cudaErrorInvalidConfiguration;
    const dim3 grid(static_cast<unsigned>(cdiv(N, kBN)),
                    static_cast<unsigned>(cdiv(M, kBM)));
    // 16-byte chunks need 16-byte aligned rows
    const bool vec_a = reinterpret_cast<uintptr_t>(A) % 16 == 0 && lda % 8 == 0;
    const bool vec_b = reinterpret_cast<uintptr_t>(B) % 16 == 0 && ldb % 8 == 0;
    gemm_wmma_kernel<TA, TB, Epi><<<grid, kWThreads, 0, s>>>(
        A, B, M, N, K, lda, ldb, vec_a, vec_b, epi);
    return cudaGetLastError();
  }
};

// -- column sums in a fixed order (db1 over g, db0 over dz) -------------------

constexpr int kCols = 32, kRowLanes = 32;

template <typename T, typename S>
__global__ void __launch_bounds__(kCols * kRowLanes)
colsum_kernel(const S* __restrict__ src, int64_t rows, int64_t cols,
              T* __restrict__ out) {
  using Acc = acc_t<T>;
  __shared__ Acc part[kRowLanes][kCols + 1];
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kCols + threadIdx.x;
  Acc s = Acc(0);
  if (col < cols)
    for (int64_t r = threadIdx.y; r < rows; r += kRowLanes)
      s += to_acc(src[r * cols + col]);
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  for (int stride = kRowLanes / 2; stride > 0; stride >>= 1) {
    if (threadIdx.y < stride)
      part[threadIdx.y][threadIdx.x] += part[threadIdx.y + stride][threadIdx.x];
    __syncthreads();
  }
  if (threadIdx.y == 0 && col < cols) store(out + col, part[0][threadIdx.x]);
}

template <typename T, typename S>
cudaError_t colsum(const S* src, int64_t rows, int64_t cols, T* out,
                   cudaStream_t s) {
  colsum_kernel<T, S><<<static_cast<unsigned>(cdiv(cols, kCols)),
                        dim3(kCols, kRowLanes), 0, s>>>(src, rows, cols, out);
  return cudaGetLastError();
}

template <typename T>
int fwd_impl(const void* x, const void* w0, const void* b0, const void* w1,
             const void* b1, void* y, void* h, int64_t B, int64_t din,
             int64_t hid, int64_t dout, void* stream) {
  if (B <= 0 || din <= 0 || hid <= 0 || dout <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* X = static_cast<const T*>(x);
  T* H = static_cast<T*>(h);
  cudaError_t e = Gemm<T>::template run<false, false>(
      X, static_cast<const T*>(w0), B, hid, din, din, hid,
      EpiBiasTanh<T>{static_cast<const T*>(b0), H, hid}, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = Gemm<T>::template run<false, false>(
      H, static_cast<const T*>(w1), B, dout, hid, hid, dout,
      EpiBias<T>{static_cast<const T*>(b1), static_cast<T*>(y), dout}, s);
  return static_cast<int>(e);
}

template <typename T>
int bwd_impl(const void* x, const void* w0, const void* w1, const void* h,
             const void* g, void* dx, void* dw0, void* db0, void* dw1,
             void* db1, void* dz, void* dzc, int64_t B, int64_t din,
             int64_t hid, int64_t dout, void* stream) {
  if (B <= 0 || din <= 0 || hid <= 0 || dout <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* X = static_cast<const T*>(x);
  const T* W0 = static_cast<const T*>(w0);
  const T* W1 = static_cast<const T*>(w1);
  const T* H = static_cast<const T*>(h);
  const T* G = static_cast<const T*>(g);
  acc_t<T>* DZ = static_cast<acc_t<T>*>(dz);
  T* DZC = static_cast<T*>(dzc);
  // dW1 (hid, dout) = h^T g: A = h stored (B, hid), transposed
  cudaError_t e = Gemm<T>::template run<true, false>(
      H, G, hid, dout, B, hid, dout,
      EpiStore<T>{static_cast<T*>(dw1), dout}, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = colsum(G, B, dout, static_cast<T*>(db1), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  // dz (B, hid) = (g W1^T) * (1 - h^2): B = W1 stored (hid, dout), transposed
  e = Gemm<T>::template run<false, true>(
      G, W1, B, hid, dout, dout, dout, EpiDz<T>{H, DZ, DZC, hid}, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = colsum(static_cast<const acc_t<T>*>(DZ), B, hid, static_cast<T*>(db0), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  // dW0 (din, hid) = x^T dz: A = x stored (B, din), transposed
  e = Gemm<T>::template run<true, false>(
      X, DZC, din, hid, B, din, hid,
      EpiStore<T>{static_cast<T*>(dw0), hid}, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  // dx (B, din) = dz W0^T: B = W0 stored (din, hid), transposed
  e = Gemm<T>::template run<false, true>(
      DZC, W0, B, din, hid, hid, hid,
      EpiStore<T>{static_cast<T*>(dx), din}, s);
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

#define MLP2_ENTRY_POINTS(SUFFIX, T)                                          \
  int mlp2_fwd_##SUFFIX(const void* x, const void* w0, const void* b0,        \
                        const void* w1, const void* b1, void* y, void* h,     \
                        int64_t B, int64_t din, int64_t hid, int64_t dout,    \
                        void* stream) {                                       \
    return fwd_impl<T>(x, w0, b0, w1, b1, y, h, B, din, hid, dout, stream);   \
  }                                                                           \
  int mlp2_bwd_##SUFFIX(const void* x, const void* w0, const void* w1,        \
                        const void* h, const void* g, void* dx, void* dw0,    \
                        void* db0, void* dw1, void* db1, void* dz, void* dzc, \
                        int64_t B, int64_t din, int64_t hid, int64_t dout,    \
                        void* stream) {                                       \
    return bwd_impl<T>(x, w0, w1, h, g, dx, dw0, db0, dw1, db1, dz, dzc, B,   \
                       din, hid, dout, stream);                               \
  }

MLP2_ENTRY_POINTS(f32, float)
MLP2_ENTRY_POINTS(f64, double)
MLP2_ENTRY_POINTS(bf16, __nv_bfloat16)

#undef MLP2_ENTRY_POINTS

}  // extern "C"
