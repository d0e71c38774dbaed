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
// K3 mlp2_fwd_<route>_<t> replaces the Pallas kernel
//    scimlsensitivity_jl_tpu/ops/pallas_mlp.py:_fwd_kernel (via
//    _fused_fwd_call). Two launches, one per product: x W0 with a bias +
//    tanh epilogue that stores h, then h W1 with a bias epilogue. The TPU
//    kernel holds all of h in VMEM; a Hopper block holds at most 227 KB, and
//    B = 1024 rows of h at hid = 2048 is 4 MB, so h makes one round trip
//    through device memory (L2 holds it: 50 MB).
// K4 mlp2_bwd_<route>_<t> replaces scimlsensitivity_jl_tpu/ops/pallas_mlp.py:
//    _bwd_kernel (via _fused_bwd). The TPU kernel is one sequential program;
//    here dz must exist in full before dW0 and dx, so K4 is two launches:
//    1. one grid over the tiles of dW1 = h^T g and dz = (g W1^T)(1 - h^2):
//       the dz tiles store dz rounded (dzc) and the column sums of the
//       unrounded dz over their rows (one row of partials per row tile, for
//       db0); blocks after the tiles sum g over 64-row chunks (for db1);
//    2. one grid over the tiles of dx = dzc W0^T and dW0 = x^T dzc, then
//       blocks that sum each column of partials in order: db0 and db1.
//
// What bounds them on an H100: at the batched field's shape (B = 1024,
// 512 -> 2048 -> 512) K3 does 4 B din hid = 4.29 GFLOP, K4 8.59. In
// bfloat16 that is 4.3 us (K4 8.7 us) at the 989 TFLOP/s tensor-core peak
// against 3.1 us of HBM time for K3's 10.5 MB; in float32, which must not
// round to TF32, 64.1 us (K4 128.2 us) at the 67 TFLOP/s of the CUDA cores'
// FMAs against 6.3 us of HBM time: arithmetic bounds both. The spiral's
// 2 -> 50 -> 2 field at B = 1 computes next to nothing: its launches are
// its cost, hence two per call.
//
// Routes, one entry point each, chosen by the caller (ops/mlp.py:mlp2_route):
//  * wgmma (bfloat16; din, hid, dout multiples of 8; 16-byte aligned
//    operands): the kernel shape of a Hopper GEMM. TMA copies 64-deep
//    operand tiles into a ring of 4-6 shared-memory stages with the 128-byte
//    swizzle, one full and one empty mbarrier per stage; one producer warp
//    keeps the loads in flight; one or two consumer warpgroups issue
//    wgmma.mma_async m64n64k16 (float32 accumulators in registers), and the
//    epilogues run from those registers with 4-byte bf16x2 stores. Every
//    operand is read as it is stored: h^T and x^T are MN-major A operands,
//    W0, W1, g and dz MN-major B operands of K3, dW1 and dW0, W1^T and W0^T
//    K-major B operands of dz and dx; the layout sits in the tensor map and
//    in wgmma's transpose bits. TMA fills rows past an edge with zeros, so B
//    is free; the row strides (din, hid, dout) must be multiples of 16 bytes.
//    Tiles: 128x64 (two consumer warpgroups, 4 stages) when their grid
//    still covers 9/10 of the SMs, else 64x64 (one warpgroup, 6 stages);
//    ~100 KB of shared memory, two blocks per SM. At S4 on 132 SMs (264
//    slots): h = x W0 256 tiles of 128x64; y = h W1 128 of 64x64; K4's
//    first launch 128 + 256 tiles of 128x64 (+ 128 blocks of g sums), its
//    second 64 + 128 (+ 10 blocks of final sums). Each product streams its
//    operands from L2, (kBM + kBN) K 2 bytes per tile: wider tiles move
//    fewer bytes but leave SMs idle or one block per SM, and on an H100
//    128x128 tiles (3 or 5 stages) and 64x128 tiles ran no S4 product
//    faster than this pair.
//  * wmma (other bfloat16 shapes): 64x64 tiles of WMMA 16x16x16 fragments,
//    storage-layout shared tiles, 16-byte loads, a register prefetch of the
//    next 32-deep slice, the epilogue through a float32 tile in shared
//    memory. Kept for ragged widths; it is the slower route.
//  * simt (float32 and float64, which must not round to TF32): the CUDA
//    cores. float32 (Ffma) is held back by how fast its FMAs are fed: a
//    thread holds 8x4 outputs of a 128x64 tile as 2x2 sub-blocks read by
//    conflict-free 16- and 8-byte shared loads (32 FMAs per 4 loads), and
//    two blocks share an SM: 109-125 registers, no spill. 8x8 per thread
//    on 128x128 tiles wants ~155 registers: at one block per SM it ran
//    slower, at two it spilled (compare_mlp2.py --variant). Both operands
//    sit in shared memory as rows of k, in a ring of 4 slices 16 deep that
//    cp.async fills while the FMAs run on an earlier slice: 16-byte copies
//    of an operand read as stored when its rows are 16-byte aligned, one
//    float per copy otherwise; an operand stored with k contiguous (x, h,
//    g, dzc as A; W1^T, W0^T as B) is turned around on the way in, one
//    float per copy. A tile inside both operands whose depth is whole
//    slices runs a main loop without edge checks; any other zero fills
//    past an edge and skips the zeros of a short last slice. At S4 the
//    products have 64-256 such tiles for 132 SMs x 2, so each launch's
//    plan (plan_launch) splits the depth of its products over blocks of
//    about equal depth, at least 256: each block of a split tile stores
//    its partial, and the tile's last block to arrive (an atomic count in
//    the call's workspace, zeroed by the launcher on the call's stream)
//    adds the partials in split order and runs the epilogue once. A launch
//    whose 128x64 blocks cannot cover the SMs (B = 1, the spiral) takes as
//    long as one block, so it takes 64x64 tiles with 4x4 outputs per
//    thread, split alike: a block of half the work (the spiral's K3 / K4
//    ~30% faster than on 128x64 tiles, compare_mlp2.py --variant).
//    float64 keeps the unpipelined 64x64 tile of 4x4 per thread (Simt):
//    its cells are B = 8 parity checks.
// Ragged edges are masked at the loads (zero fill) and at the stores.
//
// Determinism: every output element is one thread's (or one fragment's)
// sum over K in a fixed order, or, for a split float32 product, the sum of
// its splits' partials in split order, whichever block adds them; the
// column sums db0 and db1 go through fixed partials (per tile: a fixed
// shuffle tree and a fixed pass over warps) and a fixed-order final sum.
// No sum follows the order in which blocks arrive: two calls return the
// same bits. Every launcher uses the caller's stream, never synchronises,
// allocates nothing (the wrapper passes dzc, the partials and the split
// workspace), and returns the first CUDA error.

#include <atomic>
#include <climits>
#include <cstdint>
#include <initializer_list>
#include <type_traits>
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;

template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<double> { using type = double; };
template <typename T> using acc_t = typename AccOf<T>::type;

__host__ __device__ inline int64_t cdiv(int64_t a, int64_t b) {
  return (a + b - 1) / b;
}

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

// two neighbouring bfloat16 values (4-byte aligned) as floats, and back
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// -- epilogues -----------------------------------------------------------------
//
// operator() takes one output element's sum; pair() two neighbouring
// columns of one row (the wgmma route, bfloat16 only). Both return what the
// tile sums per column when kColSum (dz for db0); colsum() stores that sum.

template <typename T>
struct EpiBiasTanh {  // h = tanh(v + b0)
  static constexpr bool kColSum = false;
  const T* bias;
  T* out;
  int64_t ld;
  __device__ acc_t<T> operator()(int64_t m, int64_t n, acc_t<T> v) const {
    store(out + m * ld + n, acc_tanh(v + to_acc(bias[n])));
    return acc_t<T>(0);
  }
  __device__ float2 pair(int64_t m, int64_t n, float v0, float v1) const {
    const float2 b = load2(bias + n);
    store2(out + m * ld + n, tanhf(v0 + b.x), tanhf(v1 + b.y));
    return make_float2(0.f, 0.f);
  }
};

template <typename T>
struct EpiBias {  // y = v + b1
  static constexpr bool kColSum = false;
  const T* bias;
  T* out;
  int64_t ld;
  __device__ acc_t<T> operator()(int64_t m, int64_t n, acc_t<T> v) const {
    store(out + m * ld + n, v + to_acc(bias[n]));
    return acc_t<T>(0);
  }
  __device__ float2 pair(int64_t m, int64_t n, float v0, float v1) const {
    const float2 b = load2(bias + n);
    store2(out + m * ld + n, v0 + b.x, v1 + b.y);
    return make_float2(0.f, 0.f);
  }
};

template <typename T>
struct EpiStore {  // dW1, dW0, dx
  static constexpr bool kColSum = false;
  T* out;
  int64_t ld;
  __device__ acc_t<T> operator()(int64_t m, int64_t n, acc_t<T> v) const {
    store(out + m * ld + n, v);
    return acc_t<T>(0);
  }
  __device__ float2 pair(int64_t m, int64_t n, float v0, float v1) const {
    store2(out + m * ld + n, v0, v1);
    return make_float2(0.f, 0.f);
  }
};

template <typename T>
struct EpiDz {  // dz = dh * (1 - h*h): dzc = dz rounded to T; tile column sums of dz
  static constexpr bool kColSum = true;
  const T* h;
  T* dzc;
  int64_t ld;
  acc_t<T>* part;  // (row tiles, ld)
  __device__ acc_t<T> operator()(int64_t m, int64_t n, acc_t<T> v) const {
    const int64_t i = m * ld + n;
    const acc_t<T> hv = to_acc(h[i]);
    const acc_t<T> d = mul_rn(v, sub_rn(acc_t<T>(1), mul_rn(hv, hv)));
    store(dzc + i, d);
    return d;
  }
  __device__ float2 pair(int64_t m, int64_t n, float v0, float v1) const {
    const int64_t i = m * ld + n;
    const float2 hv = load2(h + i);
    const float d0 = mul_rn(v0, sub_rn(1.f, mul_rn(hv.x, hv.x)));
    const float d1 = mul_rn(v1, sub_rn(1.f, mul_rn(hv.y, hv.y)));
    store2(dzc + i, d0, d1);
    return make_float2(d0, d1);
  }
  __device__ void colsum(int64_t tile_row, int64_t n, acc_t<T> s) const {
    part[tile_row * ld + n] = s;
  }
};

// -- jobs: one product of a launch --------------------------------------------
//
// A is (M, K) row-major with leading dimension lda, or, when TA, stored
// (K, M); B is (K, N), or, when TB, stored (N, K).

template <typename T, bool TA_, bool TB_, typename Epi_>
struct Job {
  static constexpr bool TA = TA_, TB = TB_;
  using Epi = Epi_;
  const T* A;
  const T* B;
  int64_t M, N, K, lda, ldb;
  bool vec_a, vec_b;  // 16-byte chunk loads (WMMA)
  Epi epi;
  int tiles_n, tiles;
};

// the wgmma route's job: the operands as TMA tensor maps (packed rows)
template <bool TA_, bool TB_, typename Epi_>
struct WgJob {
  static constexpr bool TA = TA_, TB = TB_;
  using Epi = Epi_;
  CUtensorMap ma, mb;
  int64_t M, N, K;
  Epi epi;
  int tiles_n, tiles;
};

struct NoJob {
  int tiles;
};

// -- tails: the blocks after a launch's tiles -----------------------------------

struct NoTail {
  int blocks;
  __device__ void run(int, unsigned char*) const {}
};

// part[i][c] = sum of src[r][c] over the 64 rows r of chunk i, in order
template <typename T>
struct ColPartials {
  static constexpr int kRows = 64, kCols = 64;
  const T* src;
  int64_t rows, cols;
  acc_t<T>* part;
  int blocks;
  __device__ void run(int b, unsigned char* smem) const {
    using Acc = acc_t<T>;
    Acc* red = reinterpret_cast<Acc*>(smem);
    const int64_t col_blocks = cdiv(cols, kCols);
    const int64_t chunk = b / col_blocks;
    const int64_t c = (b % col_blocks) * kCols + threadIdx.x % kCols;
    const int lanes = blockDim.x / kCols, lane = threadIdx.x / kCols;
    if (lane < lanes) {
      Acc s = Acc(0);
      if (c < cols)
        for (int r = lane; r < kRows; r += lanes) {
          const int64_t gr = chunk * kRows + r;
          if (gr >= rows) break;
          s += to_acc(src[gr * cols + c]);
        }
      red[lane * kCols + threadIdx.x % kCols] = s;
    }
    __syncthreads();
    if (threadIdx.x < kCols && c < cols) {
      Acc s = red[threadIdx.x];
      for (int l = 1; l < lanes; ++l) s += red[l * kCols + threadIdx.x];
      part[chunk * cols + c] = s;
    }
  }
};

// out[c] = sum over i of part[i][c], in order of i: db0 and db1
template <typename T>
struct ColFinals {
  struct Sum {
    const acc_t<T>* part;
    int64_t parts, cols;
    T* out;
  };
  Sum s0, s1;
  int blocks0, blocks;
  __device__ void run(int b, unsigned char*) const {
    const Sum& s = b < blocks0 ? s0 : s1;
    const int64_t c =
        static_cast<int64_t>(b < blocks0 ? b : b - blocks0) * blockDim.x + threadIdx.x;
    if (c >= s.cols) return;
    acc_t<T> t = acc_t<T>(0);
    for (int64_t i = 0; i < s.parts; ++i) t += s.part[i * s.cols + c];
    store(s.out + c, t);
  }
};

// -- engine: CUDA-core tiles (float64) ------------------------------------------

template <typename T>
struct Simt {
  using Acc = acc_t<T>;
  static constexpr int kBM = 64, kBN = 64, kBK = 16;
  static constexpr int kThreads = 256, kMinBlocks = 1;  // 16 x 16, 4 x 4 outputs each
  static constexpr int kSmem = 2 * kBK * (kBM + 1) * static_cast<int>(sizeof(Acc));

  template <class J>
  static __device__ void tile(const J& job, int t, unsigned char* smem) {
    constexpr bool TA = J::TA, TB = J::TB;
    const J j = job;  // in registers: the kernel's parameters sit behind a generic pointer
    auto As = reinterpret_cast<Acc(*)[kBM + 1]>(smem);
    auto Bs = reinterpret_cast<Acc(*)[kBN + 1]>(smem + kBK * (kBM + 1) * sizeof(Acc));
    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;
    const int64_t tm = t / j.tiles_n;
    const int64_t m0 = tm * kBM;
    const int64_t n0 = static_cast<int64_t>(t % j.tiles_n) * kBN;
    Acc acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][k] = Acc(0);

    for (int64_t k0 = 0; k0 < j.K; k0 += kBK) {
      // each tile is 1024 elements, 4 per thread; the index map follows the
      // storage so that neighbouring threads read neighbouring addresses
#pragma unroll
      for (int r = 0; r < (kBM * kBK) / kThreads; ++r) {
        const int e = threadIdx.x + r * kThreads;
        const int mm = TA ? e % kBM : e / kBK;
        const int kk = TA ? e / kBM : e % kBK;
        const int64_t gm = m0 + mm, gk = k0 + kk;
        As[kk][mm] = (gm < j.M && gk < j.K)
                         ? to_acc(TA ? j.A[gk * j.lda + gm] : j.A[gm * j.lda + gk])
                         : Acc(0);
      }
#pragma unroll
      for (int r = 0; r < (kBN * kBK) / kThreads; ++r) {
        const int e = threadIdx.x + r * kThreads;
        const int nn = TB ? e / kBK : e % kBN;
        const int kk = TB ? e % kBK : e / kBN;
        const int64_t gn = n0 + nn, gk = k0 + kk;
        Bs[kk][nn] = (gn < j.N && gk < j.K)
                         ? to_acc(TB ? j.B[gn * j.ldb + gk] : j.B[gk * j.ldb + gn])
                         : Acc(0);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        Acc a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
        for (int k = 0; k < 4; ++k) b[k] = Bs[kk][tx + 16 * k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[i][k] += a[i] * b[k];
      }
      __syncthreads();
    }
    Acc cs[4] = {Acc(0), Acc(0), Acc(0), Acc(0)};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int64_t gm = m0 + ty + 16 * i, gn = n0 + tx + 16 * k;
        if (gm < j.M && gn < j.N) cs[k] += j.epi(gm, gn, acc[i][k]);
      }
    if constexpr (J::Epi::kColSum) {  // the tile's column sums, in a fixed order
      auto red = reinterpret_cast<Acc(*)[kBN + 1]>(smem);  // 16 x 65, after the last barrier
#pragma unroll
      for (int k = 0; k < 4; ++k) red[ty][tx + 16 * k] = cs[k];
      __syncthreads();
      if (threadIdx.x < kBN && n0 + threadIdx.x < j.N) {
        Acc s = red[0][threadIdx.x];
        for (int r = 1; r < 16; ++r) s += red[r][threadIdx.x];
        j.epi.colsum(tm, n0 + threadIdx.x, s);
      }
    }
  }
};

// -- engine: float32 CUDA-core tiles, pipelined, depth split over blocks ----------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// one float, or zero when !ok (src is then not read)
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
// 16 bytes, of which the first `bytes` are read and the rest zero filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// W = 4 or 2 consecutive floats from shared memory, aligned to their size
template <int W>
__device__ __forceinline__ void frag(float* r, const float* s) {
  if constexpr (W == 4) {
    const float4 v = *reinterpret_cast<const float4*>(s);
    r[0] = v.x, r[1] = v.y, r[2] = v.z, r[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(s);
    r[0] = v.x, r[1] = v.y;
  }
}

// A float32 product of a launch: Job's operands and epilogue, and the split
// of the depth: each output tile is summed by `splits` blocks, each over kc
// of K; each block stores its partial tile in `work`, and the tile's last
// block to arrive (counted in `count`) adds the partials in split order and
// runs the epilogue once.
template <bool TA_, bool TB_, typename Epi_>
struct F32Job {
  static constexpr bool TA = TA_, TB = TB_;
  using Epi = Epi_;
  const float* A;
  const float* B;
  int64_t M, N, K, lda, ldb;
  bool vec_a, vec_b;  // 16-byte copies (TA's A, non-TB's B: rows of k as stored)
  Epi epi;
  int tiles_n, out_tiles;
  int splits;         // blocks per output tile
  int64_t kc;         // depth per block, a multiple of the slice depth
  float* work;        // splits x out_tiles partial tiles when splits > 1
  unsigned* count;    // out_tiles arrival counters, zeroed before the launch
  int tiles;          // the job's blocks, out_tiles x splits (pair_kernel's count)
};

// BM x BN tiles on 256 threads (16 x 16), each thread TM x TN outputs as 2 x 2
// sub-blocks of TM/2 x TN/2 at rows ty TM/2 + [0, TM/2) and BM/2 + the same
// (columns likewise), so that a warp (4 ty by 8 tx) reads its fragments as
// contiguous 16-byte (or 8-byte) vectors: no bank conflict. (Contiguous
// 4 x 4 sub-blocks, one 16-byte load per 4 columns, ran the S4 products
// slower.) Both operands sit in shared memory as rows of k (As[k][m],
// Bs[k][n]), in a ring of kStages slices of kBK filled by cp.async while
// the FMAs run on the slice before; an operand stored with k contiguous (A
// unless TA, B when TB) is turned around on the way in, one float per
// copy, a warp reading 8 consecutive k of 4 rows, which the padded rows
// spread over 32 banks.
template <int BM, int BN, int TM, int TN, int MinBlocks>
struct Ffma {
  static constexpr int kBM = BM, kBN = BN, kBK = 16, kStages = 4, kPad = 4;
  static constexpr int kTX = BN / TN, kTY = BM / TM;
  static constexpr int kThreads = kTX * kTY, kMinBlocks = MinBlocks;
  static constexpr int kLdA = BM + kPad, kLdB = BN + kPad;  // floats per row of k
  static constexpr int kStageFloats = kBK * (kLdA + kLdB);
  static constexpr int kFlag = kStages * kStageFloats * 4;  // the split's arrival flag
  static constexpr int kSmem = kFlag + 16;
  static constexpr int kQuads = TM * TN / 4;  // float4s of a thread's partial
  static_assert(kTX == 16 && kTY == 16, "the warp layout takes 16 x 16 threads");
  static_assert((TM == 4 || TM == 8) && (TN == 4 || TN == 8), "half tiles of 2 or 4");

  // A thread's copies of one operand into a stage, C columns of it from c0
  // (rows past cols, and k past the split's depth, are zero filled). Set up
  // once per tile; copy(stage, k, depth) fetches the slice at depth k of
  // the split (depth: the split's).
  //
  // Rows: an operand stored as rows of k (element (k, c) at G[k ld + c]),
  // in 16-byte chunks of 4 columns when vec (aligned rows), else one float
  // per copy; chunk i of a slice is row i / (C / 4), columns 4 (i % (C / 4)).
  template <int C, int LD>
  struct Rows {
    static constexpr int kPerRow = C / 4, kStep = kThreads / kPerRow, kCopies = kBK / kStep;
    const float* G;    // the operand: a valid address for a zero-filled copy
    const float* src;  // the thread's first chunk at depth 0
    int64_t ld;
    uint32_t dst;      // its offset in a stage
    int kk, left;      // its row in the slice; its columns inside the operand
    bool vec;
    __device__ Rows(const float* G_, int64_t ld_, int64_t kb, int64_t c0, int64_t cols,
                    bool vec_)
        : G(G_), ld(ld_), vec(vec_) {
      kk = threadIdx.x / kPerRow;
      const int c = (threadIdx.x % kPerRow) * 4;
      src = G + (kb + kk) * ld + c0 + c;
      const int64_t l = cols - c0 - c;
      left = l <= 0 ? 0 : l >= 4 ? 4 : static_cast<int>(l);
      dst = (kk * LD + c) * 4;
    }
    // every chunk of the tile lies inside the operand and takes 16 bytes
    __device__ bool whole(int64_t c0, int64_t cols) const { return vec && c0 + C <= cols; }
    __device__ __forceinline__ void copy_whole(uint32_t stage, int64_t k) const {
      const float* p = src + k * ld;
#pragma unroll
      for (int r = 0; r < kCopies; ++r)
        cp_async16(stage + dst + r * kStep * LD * 4, p + r * kStep * ld, 16);
    }
    __device__ __forceinline__ void copy(uint32_t stage, int64_t k, int64_t depth) const {
      const float* p = src + k * ld;
#pragma unroll
      for (int r = 0; r < kCopies; ++r) {
        const bool in = k + kk + r * kStep < depth;
        const uint32_t d = stage + dst + r * kStep * LD * 4;
        const float* q = p + r * kStep * ld;
        if (vec) {
          const int bytes = in ? 4 * left : 0;
          cp_async16(d, bytes ? q : G, bytes);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = in && e < left;
            cp_async4(d + 4 * e, ok ? q + e : G, ok);
          }
        }
      }
    }
  };

  // Turned: an operand stored with k contiguous (element (k, c) at
  // G[c ld + k]), turned around one float per copy: a thread takes one k of
  // the slice, k = t % 8 + 8 ((t / 32) % 2), in the columns c + 16 r, c =
  // (t / 8) % 4 + 4 (t / 64), so that a warp reads 8 consecutive k of 4
  // rows and writes 32 distinct banks.
  template <int C, int LD>
  struct Turned {
    static constexpr int kCopies = kBK * C / kThreads;
    const float* G;
    const float* src;  // the thread's first float at depth 0
    int64_t ld;
    uint32_t dst;
    int kk;
    unsigned cols_in;  // bit r: column c + 16 r lies inside the operand
    __device__ Turned(const float* G_, int64_t ld_, int64_t kb, int64_t c0, int64_t cols, bool)
        : G(G_), ld(ld_) {
      const int t = threadIdx.x;
      kk = (t & 7) | ((t >> 2) & 8);
      const int c = ((t >> 3) & 3) | ((t >> 6) << 2);
      src = G + (c0 + c) * ld + kb + kk;
      dst = (kk * LD + c) * 4;
      cols_in = 0;
#pragma unroll
      for (int r = 0; r < kCopies; ++r)
        if (c0 + c + 16 * r < cols) cols_in |= 1u << r;
    }
    __device__ bool whole(int64_t c0, int64_t cols) const { return c0 + C <= cols; }
    __device__ __forceinline__ void copy_whole(uint32_t stage, int64_t k) const {
      const float* p = src + k;
#pragma unroll
      for (int r = 0; r < kCopies; ++r) cp_async4(stage + dst + 64 * r, p + 16 * r * ld, true);
    }
    __device__ __forceinline__ void copy(uint32_t stage, int64_t k, int64_t depth) const {
      const bool in = k + kk < depth;
      const float* p = src + k;
#pragma unroll
      for (int r = 0; r < kCopies; ++r) {
        const bool ok = in && ((cols_in >> r) & 1u);
        cp_async4(stage + dst + 64 * r, ok ? p + 16 * r * ld : G, ok);
      }
    }
  };

  template <class J>
  static __device__ __forceinline__ void tile(const J& j, int b, unsigned char* smem) {
    constexpr bool TA = J::TA, TB = J::TB;
    constexpr int HM = TM / 2, HN = TN / 2;
    // row i of a thread: ty HM + i in the tile's first half, then the same
    // rows of its second half (columns likewise)
    auto row = [](int i, int ty) { return i < HM ? ty * HM + i : BM / 2 + ty * HM + i - HM; };
    auto col = [](int k, int tx) { return k < HN ? tx * HN + k : BN / 2 + tx * HN + k - HN; };
    const int ot = b % j.out_tiles, split = b / j.out_tiles;  // output tile, split
    const int64_t tm = ot / j.tiles_n;
    const int64_t m0 = tm * BM;
    const int64_t n0 = static_cast<int64_t>(ot % j.tiles_n) * BN;
    const int64_t kb = split * j.kc;
    const int64_t ke = kb + j.kc < j.K ? kb + j.kc : j.K;
    const int nk = static_cast<int>(cdiv(ke - kb, kBK));
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int tx = (warp % 2) * 8 + lane % 8, ty = (warp / 2) * 4 + lane / 8;
    const uint32_t ring = smem_u32(smem);
    using FeedA = typename std::conditional<TA, Rows<BM, kLdA>, Turned<BM, kLdA>>::type;
    using FeedB = typename std::conditional<TB, Turned<BN, kLdB>, Rows<BN, kLdB>>::type;
    const FeedA fa(j.A, j.lda, kb, m0, j.M, j.vec_a);
    const FeedB fb(j.B, j.ldb, kb, n0, j.N, j.vec_b);

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int k = 0; k < TN; ++k) acc[i][k] = 0.f;
    auto step = [&](const float* As, const float* Bs) {  // one k of the slice
      float a[TM], bv[TN];
      frag<HM>(a, As + row(0, ty));
      frag<HM>(a + HM, As + row(HM, ty));
      frag<HN>(bv, Bs + col(0, tx));
      frag<HN>(bv + HN, Bs + col(HN, tx));
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int k = 0; k < TN; ++k) acc[i][k] = fmaf(a[i], bv[k], acc[i][k]);
    };

    // the main loop, in two copies: a tile inside both operands whose split
    // is whole slices deep copies without a check; any other checks every
    // copy and skips the zeros of a last, partial slice
    auto run = [&](auto whole) {
      constexpr bool kWhole = decltype(whole)::value;
      auto load = [&](int kt) {  // slice kt into its stage
        const uint32_t sa = ring + (kt % kStages) * kStageFloats * 4;
        const int64_t k = static_cast<int64_t>(kt) * kBK;
        if constexpr (kWhole) {
          fa.copy_whole(sa, k);
          fb.copy_whole(sa + kBK * kLdA * 4, k);
        } else {
          fa.copy(sa, k, ke - kb);
          fb.copy(sa + kBK * kLdA * 4, k, ke - kb);
        }
      };
#pragma unroll
      for (int s = 0; s < kStages - 1; ++s) {
        if (s < nk) load(s);
        cp_async_commit();
      }
      for (int kt = 0; kt < nk; ++kt) {
        cp_async_wait<kStages - 2>();  // slice kt has landed
        __syncthreads();               // and every thread is done with slice kt - 1
        if (kt + kStages - 1 < nk) load(kt + kStages - 1);  // into slice kt - 1's stage
        cp_async_commit();
        const float* As = reinterpret_cast<const float*>(smem) + (kt % kStages) * kStageFloats;
        const float* Bs = As + kBK * kLdA;
        const int64_t kn = ke - kb - static_cast<int64_t>(kt) * kBK;
        if (kWhole || kn >= kBK) {
#pragma unroll
          for (int kk = 0; kk < kBK; ++kk) step(As + kk * kLdA, Bs + kk * kLdB);
        } else {
          for (int kk = 0; kk < kn; ++kk) step(As + kk * kLdA, Bs + kk * kLdB);
        }
      }
    };
    if (fa.whole(m0, j.M) && fb.whole(n0, j.N) && (ke - kb) % kBK == 0)
      run(std::true_type{});
    else
      run(std::false_type{});
    cp_async_wait<0>();
    __syncthreads();  // the ring is free

    if (j.splits > 1) {  // store the partial; the tile's last block sums them in order
      const int64_t per_tile = static_cast<int64_t>(kQuads) * kThreads;
      float4* own = reinterpret_cast<float4*>(j.work) +
                    (static_cast<int64_t>(split) * j.out_tiles + ot) * per_tile + threadIdx.x;
#pragma unroll
      for (int q = 0; q < kQuads; ++q) {
        const int i = q / (TN / 4), k = (q % (TN / 4)) * 4;
        own[q * kThreads] = make_float4(acc[i][k], acc[i][k + 1], acc[i][k + 2], acc[i][k + 3]);
      }
      __threadfence();
      __syncthreads();
      unsigned* flag = reinterpret_cast<unsigned*>(smem + kFlag);
      if (threadIdx.x == 0) {
        const unsigned arrived = atomicAdd(j.count + ot, 1u) + 1u;  // relaxed, gpu scope
        *flag = arrived == static_cast<unsigned>(j.splits);
      }
      __syncthreads();
      if (!*flag) return;
      __threadfence();
      const float4* part = reinterpret_cast<const float4*>(j.work) +
                           static_cast<int64_t>(ot) * per_tile + threadIdx.x;
      const int64_t stride = static_cast<int64_t>(j.out_tiles) * per_tile;  // split to split
#pragma unroll
      for (int q = 0; q < kQuads; ++q) {
        const int i = q / (TN / 4), k = (q % (TN / 4)) * 4;
        const float4 mine = make_float4(acc[i][k], acc[i][k + 1], acc[i][k + 2], acc[i][k + 3]);
        float4 s = split == 0 ? mine : __ldcg(part + q * kThreads);
        for (int p = 1; p < j.splits; ++p) {
          const float4 v = p == split ? mine : __ldcg(part + p * stride + q * kThreads);
          s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
        }
        acc[i][k] = s.x, acc[i][k + 1] = s.y, acc[i][k + 2] = s.z, acc[i][k + 3] = s.w;
      }
    }

    float cs[TN];
#pragma unroll
    for (int k = 0; k < TN; ++k) cs[k] = 0.f;
    const auto epi = j.epi;  // in registers
    const int64_t M = j.M, N = j.N;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int64_t gm = m0 + row(i, ty);
#pragma unroll
      for (int k = 0; k < TN; ++k) {
        const int64_t gn = n0 + col(k, tx);
        if (gm < M && gn < N) cs[k] += epi(gm, gn, acc[i][k]);
      }
    }
    if constexpr (J::Epi::kColSum) {  // the tile's column sums: over ty, in order
      float* red = reinterpret_cast<float*>(smem);  // kTY x BN
#pragma unroll
      for (int k = 0; k < TN; ++k)
        red[ty * BN + col(k, tx)] = cs[k];
      __syncthreads();
      if (threadIdx.x < BN && n0 + threadIdx.x < N) {
        float s = red[threadIdx.x];
        for (int r = 1; r < kTY; ++r) s += red[r * BN + threadIdx.x];
        epi.colsum(tm, n0 + threadIdx.x, s);
      }
    }
  }
};

// the float32 tile plans, two blocks per SM: 128 x 64 (8 x 4 per thread)
// where a launch's blocks cover the SMs; else the launch takes as long as
// one block, and a 64 x 64 block (4 x 4 per thread) takes less. On an H100
// (compare_mlp2.py --variant final big-only 64x64): the spiral's K3 / K4
// ~7.3 / ~6.7 us on this pair, ~10.4 / ~10.9 us on 128 x 64 alone; S4
// float32 ~130 / ~255 us on this pair, ~159 / ~303 us on 64 x 64 alone.
using FfmaBig = Ffma<128, 64, 8, 4, 2>;
using FfmaSmall = Ffma<64, 64, 4, 4, 2>;

// -- engine: WMMA tiles (bfloat16 of any shape) ----------------------------------
//
// Each shared tile keeps the layout of its operand's storage, so every
// thread moves whole 16-byte chunks (8 values) from device memory, and a
// transposed operand is read by a column-major fragment instead of being
// transposed on the way in. The next depth slice is loaded into registers
// while the tensor cores work on the current one.

constexpr int kWK = 32;  // depth of a shared tile
constexpr int kPad = 8;  // row padding (elements): rows stay 16-byte aligned

// A tile of `R` rows whose `C` values each lie contiguous in storage, with
// row r0 + r and column c0 + c at G[(r0 + r) * ld + c0 + c]. Chunk `i`
// (of R * C / 8) is 8 values of one row.
template <int R, int C, int kThreads>
struct Tile {
  static constexpr int kPerThread = R * C / 8 / kThreads;
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

struct Wmma {
  static constexpr int kBM = 64, kBN = 64;
  static constexpr int kThreads = 128, kMinBlocks = 1;  // 4 warps, each a 32 x 32 quarter
  static constexpr int kCld = kBN + 4;                  // padded leading dimension of C
  static constexpr int kOpBytes = 64 * (kWK + kPad) * 2;  // the larger operand tile
  static constexpr int kSmem = 2 * kOpBytes + kBM * kCld * 4;

  template <class J>
  static __device__ void tile(const J& job, int t, unsigned char* smem) {
    using namespace nvcuda;
    constexpr bool TA = J::TA, TB = J::TB;
    const J j = job;  // in registers, as in Simt::tile
    // storage layouts: A is (m, k) or, when TA, (k, m); B is (k, n) or, when
    // TB, (n, k); the contiguous index is the second
    constexpr int AR = TA ? kWK : kBM, AC = TA ? kBM : kWK;
    constexpr int BR = TB ? kBN : kWK, BC = TB ? kWK : kBN;
    using TileA = Tile<AR, AC, kThreads>;
    using TileB = Tile<BR, BC, kThreads>;
    using LayoutA = typename std::conditional<TA, wmma::col_major,
                                              wmma::row_major>::type;
    using LayoutB = typename std::conditional<TB, wmma::col_major,
                                              wmma::row_major>::type;
    auto As = reinterpret_cast<bf16(*)[AC + kPad]>(smem);
    auto Bs = reinterpret_cast<bf16(*)[BC + kPad]>(smem + kOpBytes);
    auto Cs = reinterpret_cast<float(*)[kCld]>(smem + 2 * kOpBytes);
    const int warp = threadIdx.x / 32;
    const int wr = (warp / 2) * 32, wc = (warp % 2) * 32;
    const int64_t tm = t / j.tiles_n;
    const int64_t m0 = tm * kBM;
    const int64_t n0 = static_cast<int64_t>(t % j.tiles_n) * kBN;
    const int64_t a_rows = TA ? j.K : j.M, a_cols = TA ? j.M : j.K;
    const int64_t b_rows = TB ? j.N : j.K, b_cols = TB ? j.K : j.N;

    uint4 ra[TileA::kPerThread], rb[TileB::kPerThread];
    auto fetch = [&](int64_t k0) {  // (row, column) origin of each tile in its storage
#pragma unroll
      for (int i = 0; i < TileA::kPerThread; ++i)
        ra[i] = TileA::load(j.A, j.lda, TA ? k0 : m0, TA ? m0 : k0, a_rows,
                            a_cols, threadIdx.x + i * kThreads, j.vec_a);
#pragma unroll
      for (int i = 0; i < TileB::kPerThread; ++i)
        rb[i] = TileB::load(j.B, j.ldb, TB ? n0 : k0, TB ? k0 : n0, b_rows,
                            b_cols, threadIdx.x + i * kThreads, j.vec_b);
    };
    auto stage = [&]() {
#pragma unroll
      for (int i = 0; i < TileA::kPerThread; ++i)
        TileA::store(As, threadIdx.x + i * kThreads, ra[i]);
#pragma unroll
      for (int i = 0; i < TileB::kPerThread; ++i)
        TileB::store(Bs, threadIdx.x + i * kThreads, rb[i]);
    };

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int k = 0; k < 2; ++k) wmma::fill_fragment(c[i][k], 0.0f);

    fetch(0);
    stage();
    __syncthreads();
    for (int64_t k0 = 0; k0 < j.K; k0 += kWK) {
      const bool more = k0 + kWK < j.K;
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
        for (int k = 0; k < 2; ++k) {
          const bf16* pb = TB ? &Bs[wc + 16 * k][kk] : &Bs[kk][wc + 16 * k];
          wmma::load_matrix_sync(b[k], pb, BC + kPad);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int k = 0; k < 2; ++k) wmma::mma_sync(c[i][k], a[i], b[k], c[i][k]);
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
      for (int k = 0; k < 2; ++k)
        wmma::store_matrix_sync(&Cs[wr + 16 * i][wc + 16 * k], c[i][k], kCld,
                                wmma::mem_row_major);
    __syncthreads();
    for (int e = threadIdx.x; e < kBM * kBN; e += kThreads) {
      const int mm = e / kBN, nn = e % kBN;
      const int64_t gm = m0 + mm, gn = n0 + nn;
      float d = 0.f;
      if (gm < j.M && gn < j.N) d = j.epi(gm, gn, Cs[mm][nn]);
      if constexpr (J::Epi::kColSum) Cs[mm][nn] = d;
    }
    if constexpr (J::Epi::kColSum) {  // the tile's column sums, rows in order
      __syncthreads();
      if (threadIdx.x < kBN && n0 + threadIdx.x < j.N) {
        float s = Cs[0][threadIdx.x];
        for (int mm = 1; mm < kBM; ++mm) s += Cs[mm][threadIdx.x];
        j.epi.colsum(tm, n0 + threadIdx.x, s);
      }
    }
  }
};

// -- engine: wgmma tiles fed by TMA (bfloat16, aligned widths) -------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// wait until the phase of parity `parity` has completed; a wait of more than
// 10 s traps, so a broken pipeline fails its launch instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  uint64_t t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  while (!mbar_try_wait(bar, parity)) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (t - t0 > 10000000000ull) __trap();
  }
}
// a 2-D box at coordinates (c0 along the contiguous dimension, c1) into
// shared memory; completion counts its bytes on the barrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads across a wait
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle. Every tile is a stack
// of 128-byte rows (64 bf16 values along the contiguous dimension), 8-row
// groups 1024 bytes apart (the stride byte offset). A K-major operand (K
// contiguous) advances 32 bytes per 16-deep step inside its rows; an
// MN-major one 16 rows (2048 bytes), with its 64-wide MN slabs 8192 bytes
// apart (the leading byte offset).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

#define MLP2_ACC8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 64, float32) += A (64 x 16) B (16 x 64); TA / TB: the operand is
// MN-major (wgmma's transpose bits)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : MLP2_ACC8(0), MLP2_ACC8(8), MLP2_ACC8(16), MLP2_ACC8(24)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}
#undef MLP2_ACC8

// NWG consumer warpgroups, each 64 rows of a (64 NWG) x 64 tile, and one
// producer warp after them
template <int NWG>
struct Wg {
  static constexpr int kBM = 64 * NWG, kBN = 64, kBK = 64;
  static constexpr int kConsumers = 128 * NWG;
  static constexpr int kThreads = kConsumers + 32, kMinBlocks = 2;
  static constexpr int kABytes = kBM * kBK * 2, kBBytes = kBN * kBK * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStages = (96 * 1024) / kStageBytes;  // 4 (128x64) or 6 (64x64)
  static constexpr int kSlab = 64 * 128;  // one 64-row (or 64-deep) box of 128-byte rows
  static constexpr int kRedBytes = 4 * NWG * kBN * 4;  // per-warp column sums
  // 1024 bytes of slack to align the ring to the swizzle's 1024-byte period
  static constexpr int kSmem = 1024 + kStages * kStageBytes + 16 * kStages + kRedBytes;

  template <class J>
  static __device__ void tile(const J& j, int t, unsigned char* smem) {
    constexpr bool TA = J::TA, TB = J::TB;
    const int64_t tm = t / j.tiles_n;
    const int64_t m0 = tm * kBM;
    const int64_t n0 = static_cast<int64_t>(t % j.tiles_n) * kBN;
    const int ktiles = static_cast<int>(cdiv(j.K, kBK));
    const uint32_t raw = smem_u32(smem);
    const uint32_t ring = (raw + 1023u) & ~1023u;
    const uint32_t bars = ring + kStages * kStageBytes;  // full[s], then empty[s]
    float* red = reinterpret_cast<float*>(smem + (bars + 16 * kStages - raw));
    auto full = [&](int s) { return bars + 8u * s; };
    auto empty = [&](int s) { return bars + 8u * (kStages + s); };
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(full(s), 1);
        mbar_init(empty(s), 4 * NWG);  // one arrival per consumer warp
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (threadIdx.x >= kConsumers) {  // producer warp: one thread issues the loads
      if (threadIdx.x == kConsumers)
        for (int kt = 0; kt < ktiles; ++kt) {
          const int s = kt % kStages;
          mbar_wait(empty(s), ((kt / kStages) & 1) ^ 1);
          mbar_expect_tx(full(s), kStageBytes);
          const uint32_t sa = ring + s * kStageBytes, sb = sa + kABytes;
          const int k0 = kt * kBK;
          if (TA)  // A stored (K, M): 64-wide M slabs, 64 deep
            for (int i = 0; i < NWG; ++i)
              tma_load(sa + i * kSlab, &j.ma, static_cast<int>(m0) + 64 * i, k0, full(s));
          else  // A stored (M, K): kBM rows, 64 deep
            tma_load(sa, &j.ma, k0, static_cast<int>(m0), full(s));
          if (TB)  // B stored (N, K): kBN rows, 64 deep
            tma_load(sb, &j.mb, k0, static_cast<int>(n0), full(s));
          else  // B stored (K, N): one 64-wide N slab, 64 deep
            tma_load(sb, &j.mb, static_cast<int>(n0), k0, full(s));
        }
      return;
    }

    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    float acc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < ktiles; ++kt) {
      const int s = kt % kStages;
      mbar_wait(full(s), (kt / kStages) & 1);
      const uint32_t sa = ring + s * kStageBytes + wg * kSlab, sb = ring + s * kStageBytes + kABytes;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t da = TA ? smem_desc(sa + kk * 2048, kSlab, 1024)
                               : smem_desc(sa + kk * 32, 16, 1024);
        const uint64_t db = TB ? smem_desc(sb + kk * 32, 16, 1024)
                               : smem_desc(sb + kk * 2048, kSlab, 1024);
        wgmma_n64<TA ? 1 : 0, TB ? 0 : 1>(acc, da, db);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: release it
      fence_acc(acc);
      if (kt > 0 && lane == 0) mbar_arrive(empty((kt - 1) % kStages));
    }
    wgmma_wait<0>();
    fence_acc(acc);

    // acc[4 c + 2 h + e] holds row 16 warp + lane / 4 + 8 h, column
    // 8 c + 2 (lane % 4) + e of the warpgroup's 64 rows
    const int64_t r0 = m0 + 64 * wg + 16 * warp + lane / 4;
    const auto epi = j.epi;  // in registers
    const int64_t M = j.M, N = j.N;
#pragma unroll
    for (int c = 0; c < kBN / 8; ++c) {
      const int64_t col = n0 + 8 * c + 2 * (lane % 4);
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t row = r0 + 8 * h;
        if (row < M && col < N) {
          const float2 d = epi.pair(row, col, acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
          s0 += d.x;
          s1 += d.y;
        }
      }
      if constexpr (J::Epi::kColSum) {  // over the warp's 16 rows, a fixed tree
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, o);
          s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        }
        if (lane < 4) {
          red[(4 * wg + warp) * kBN + 8 * c + 2 * lane] = s0;
          red[(4 * wg + warp) * kBN + 8 * c + 2 * lane + 1] = s1;
        }
      }
    }
    if constexpr (J::Epi::kColSum) {  // then over the warps, in order
      asm volatile("bar.sync 1, %0;" ::"r"(kConsumers) : "memory");
      if (threadIdx.x < kBN && n0 + threadIdx.x < N) {
        float s = red[threadIdx.x];
        for (int w = 1; w < 4 * NWG; ++w) s += red[w * kBN + threadIdx.x];
        epi.colsum(tm, n0 + threadIdx.x, s);
      }
    }
  }
};

// -- the kernel: a launch's tiles, job after job, then its tail blocks -----------

template <class Eng, class J0, class J1, class Tail>
__global__ void __launch_bounds__(Eng::kThreads, Eng::kMinBlocks)
pair_kernel(const __grid_constant__ J0 j0, const __grid_constant__ J1 j1,
            const __grid_constant__ Tail tail) {
  extern __shared__ __align__(128) unsigned char smem[];
  int b = static_cast<int>(blockIdx.x);
  if (b < j0.tiles) {
    Eng::tile(j0, b, smem);
    return;
  }
  b -= j0.tiles;
  if constexpr (!std::is_same<J1, NoJob>::value) {
    if (b < j1.tiles) {
      Eng::tile(j1, b, smem);
      return;
    }
    b -= j1.tiles;
  }
  tail.run(b, smem);
}

template <class Eng, class J0, class J1, class Tail>
cudaError_t launch(const J0& j0, const J1& j1, const Tail& tail, cudaStream_t s) {
  auto* kern = pair_kernel<Eng, J0, J1, Tail>;
  if constexpr (Eng::kSmem > 48 * 1024) {  // once per kernel and device
    static std::atomic<uint64_t> done{0};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    const uint64_t bit = 1ull << (dev & 63);
    if (!(done.load() & bit)) {
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Eng::kSmem);
      if (e != cudaSuccess) return e;
      done.fetch_or(bit);
    }
  }
  const int64_t blocks = static_cast<int64_t>(j0.tiles) + j1.tiles + tail.blocks;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  kern<<<static_cast<unsigned>(blocks), Eng::kThreads, Eng::kSmem, s>>>(j0, j1, tail);
  return cudaGetLastError();
}

// tile counts stay far inside an int (the entry points check the widths)
inline int tiles_of(int64_t M, int64_t N, int bm, int bn) {
  return static_cast<int>(cdiv(M, bm) * cdiv(N, bn));
}

inline bool widths_fit(int64_t B, int64_t din, int64_t hid, int64_t dout) {
  const int64_t lim = int64_t(1) << 26;  // and under 2^29 tiles of 64 x 64 per launch
  return B < lim && din < lim && hid < lim && dout < lim &&
         cdiv(B, 64) * cdiv(hid, 64) < (int64_t(1) << 28) &&
         cdiv(hid, 64) * cdiv(dout, 64) < (int64_t(1) << 28) &&
         cdiv(din, 64) * cdiv(hid, 64) < (int64_t(1) << 28) &&
         cdiv(B, 64) * (cdiv(din, 64) + cdiv(dout, 64)) < (int64_t(1) << 28);
}

template <class Eng, bool TA, bool TB, typename T, typename Epi>
Job<T, TA, TB, Epi> make_job(const T* A, const T* B, int64_t M, int64_t N,
                             int64_t K, int64_t lda, int64_t ldb, Epi epi) {
  Job<T, TA, TB, Epi> j{};
  j.A = A;
  j.B = B;
  j.M = M;
  j.N = N;
  j.K = K;
  j.lda = lda;
  j.ldb = ldb;
  // 16-byte chunks need 16-byte aligned rows
  j.vec_a = reinterpret_cast<uintptr_t>(A) % 16 == 0 && lda % 8 == 0;
  j.vec_b = reinterpret_cast<uintptr_t>(B) % 16 == 0 && ldb % 8 == 0;
  j.epi = epi;
  j.tiles_n = static_cast<int>(cdiv(N, Eng::kBN));
  j.tiles = tiles_of(M, N, Eng::kBM, Eng::kBN);
  return j;
}

template <typename T>
ColPartials<T> make_partials(const T* src, int64_t rows, int64_t cols, acc_t<T>* part) {
  return {src, rows, cols, part,
          static_cast<int>(cdiv(rows, ColPartials<T>::kRows) *
                           cdiv(cols, ColPartials<T>::kCols))};
}

template <class Eng, typename T>
ColFinals<T> make_finals(typename ColFinals<T>::Sum s0, typename ColFinals<T>::Sum s1) {
  const int b0 = static_cast<int>(cdiv(s0.cols, Eng::kThreads));
  return {s0, s1, b0, b0 + static_cast<int>(cdiv(s1.cols, Eng::kThreads))};
}

// -- TMA tensor maps -------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's encoder through the runtime, looked up once: no -lcuda
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// a packed row-major (rows, cols) bfloat16 matrix, read in boxes of 64
// columns (128 bytes) by box_rows rows with the 128-byte swizzle; reads past
// an edge fill zeros
cudaError_t encode(CUtensorMap* map, const bf16* base, int64_t rows, int64_t cols,
                   int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(bf16)};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<bf16*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <class Eng, bool TA, bool TB, typename Epi>
cudaError_t make_wg_job(WgJob<TA, TB, Epi>& j, const bf16* A, const bf16* B,
                        int64_t M, int64_t N, int64_t K, Epi epi) {
  // A: (K, M) when TA (64-row boxes), else (M, K) (kBM-row boxes); B: (N, K)
  // when TB (kBN-row boxes), else (K, N) (64-row boxes)
  cudaError_t e = TA ? encode(&j.ma, A, K, M, 64) : encode(&j.ma, A, M, K, Eng::kBM);
  if (e != cudaSuccess) return e;
  e = TB ? encode(&j.mb, B, N, K, Eng::kBN) : encode(&j.mb, B, K, N, 64);
  if (e != cudaSuccess) return e;
  j.M = M;
  j.N = N;
  j.K = K;
  j.epi = epi;
  j.tiles_n = static_cast<int>(cdiv(N, Eng::kBN));
  j.tiles = tiles_of(M, N, Eng::kBM, Eng::kBN);
  return cudaSuccess;
}

int sm_count() {
  static std::atomic<int> cache[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  std::atomic<int>& slot = cache[dev & 63];
  int n = slot.load();
  if (n == 0 && cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess)
    slot.store(n);
  return n;
}

// 128x64 tiles when their grid (count(128, 64) blocks) still covers 9/10 of
// the SMs, else 64x64; run(Wg<...>{}) launches with it
template <class Count, class Run>
cudaError_t with_wg_tile(Count count, Run run) {
  if (int64_t(count(128, 64)) * 10 >= 9 * int64_t(sm_count())) return run(Wg<2>{});
  return run(Wg<1>{});
}

// -- the entry points' bodies ------------------------------------------------------

template <typename T>
struct Args {
  const T *x, *w0, *b0, *w1, *b1, *h, *g;
  T *y, *hout, *dx, *dw0, *db0, *dw1, *db1, *dzc;
  acc_t<T>* part;  // cdiv(B, 64) rows of hid, then cdiv(B, 64) rows of dout
  float* work;  // float32 route: the split products' partial tiles, then
                // their arrival counters (mlp2_simt_f32_workspace)
  int64_t B, din, hid, dout;
  cudaStream_t s;
};

// -- float32 launch plans: the tile, and the split of each product's depth --------

constexpr int64_t kMinSplitDepth = 256;  // a split block sums at least this deep

struct Prod {
  int64_t M, N, K;
};
struct SplitPlan {
  int splits;
  int64_t kc;
};
struct LaunchPlan {
  bool big;  // FfmaBig, else FfmaSmall
  int n;     // products in the launch
  Prod prod[2];
  SplitPlan split[2];
  int bm() const { return big ? FfmaBig::kBM : FfmaSmall::kBM; }
  int bn() const { return big ? FfmaBig::kBN : FfmaSmall::kBN; }
};

// The launch's blocks, kMinBlocks per SM, each about as deep as the
// launch's products (tiles times depth) over those slots, at least
// kMinSplitDepth: each product's depth is cut into that many equal splits
// (in slices of kBK), none shallower than kMinSplitDepth unless K is.
template <class Eng>
void plan_splits(LaunchPlan& p) {
  int64_t work = 0;
  for (int i = 0; i < p.n; ++i)
    work += int64_t(tiles_of(p.prod[i].M, p.prod[i].N, Eng::kBM, Eng::kBN)) * p.prod[i].K;
  const int64_t slots = int64_t(Eng::kMinBlocks) * (sm_count() > 0 ? sm_count() : 1);
  int64_t depth = cdiv(cdiv(work, slots), Eng::kBK) * Eng::kBK;
  if (depth < kMinSplitDepth) depth = kMinSplitDepth;
  for (int i = 0; i < p.n; ++i) {
    const int64_t K = p.prod[i].K, most = K / kMinSplitDepth;
    int64_t s = cdiv(K, depth);
    if (s > most) s = most > 1 ? most : 1;
    const int64_t kc = cdiv(cdiv(K, s), Eng::kBK) * Eng::kBK;
    p.split[i] = {static_cast<int>(cdiv(K, kc)), kc};
  }
}

// The big tile when the launch's products, split no finer than
// kMinSplitDepth, have a block of it for every SM.
LaunchPlan plan_launch(std::initializer_list<Prod> prods) {
  LaunchPlan p{};
  int64_t blocks = 0;
  for (const Prod& q : prods) {
    p.prod[p.n++] = q;
    const int64_t deep = q.K / kMinSplitDepth;
    blocks += int64_t(tiles_of(q.M, q.N, FfmaBig::kBM, FfmaBig::kBN)) * (deep > 1 ? deep : 1);
  }
  p.big = blocks >= sm_count();
  if (p.big) plan_splits<FfmaBig>(p);
  else plan_splits<FfmaSmall>(p);
  return p;
}

// the launch's split workspace: partial floats and arrival counters
void plan_workspace(const LaunchPlan& p, int64_t& floats, int64_t& counters) {
  const int bm = p.bm(), bn = p.bn();
  floats = counters = 0;
  for (int i = 0; i < p.n; ++i) {
    if (p.split[i].splits < 2) continue;
    const int64_t t = tiles_of(p.prod[i].M, p.prod[i].N, bm, bn);
    floats += p.split[i].splits * t * bm * bn;
    counters += t;
  }
}

// K3's two launches or K4's two, each with its one or two products
void plans_of(int64_t B, int64_t din, int64_t hid, int64_t dout, bool bwd, LaunchPlan (&p)[2]) {
  if (!bwd) {
    p[0] = plan_launch({{B, hid, din}});   // h = tanh(x W0 + b0)
    p[1] = plan_launch({{B, dout, hid}});  // y = h W1 + b1
  } else {
    p[0] = plan_launch({{hid, dout, B}, {B, hid, dout}});  // dW1, dz
    p[1] = plan_launch({{B, din, hid}, {din, hid, B}});    // dx, dW0
  }
}

// The call's split workspace, in 4-byte words: the larger launch's partial
// floats (the two launches run in turn), then both launches' counters.
// *counters gets the counters, *floats the offset at which they start.
int64_t f32_workspace(int64_t B, int64_t din, int64_t hid, int64_t dout, bool bwd,
                      int64_t* floats, int64_t* counters) {
  LaunchPlan p[2];
  plans_of(B, din, hid, dout, bwd, p);
  *floats = *counters = 0;
  for (const LaunchPlan& q : p) {
    int64_t f, c;
    plan_workspace(q, f, c);
    *floats = f > *floats ? f : *floats;
    *counters += c;
  }
  return *counters ? *floats + *counters : 0;
}

// a product of launch plan p: its tiles, its split, and its share of the
// workspace, which it takes from the front of work and count
template <class Eng, bool TA, bool TB, typename Epi>
F32Job<TA, TB, Epi> make_f32_job(const LaunchPlan& p, int i, const float* A, const float* B,
                                 int64_t lda, int64_t ldb, Epi epi, float*& work,
                                 unsigned*& count) {
  F32Job<TA, TB, Epi> j{};
  j.A = A;
  j.B = B;
  j.M = p.prod[i].M;
  j.N = p.prod[i].N;
  j.K = p.prod[i].K;
  j.lda = lda;
  j.ldb = ldb;
  // an operand read as stored (rows of k) takes 16-byte copies when its rows
  // are 16-byte aligned
  j.vec_a = TA && reinterpret_cast<uintptr_t>(A) % 16 == 0 && lda % 4 == 0;
  j.vec_b = !TB && reinterpret_cast<uintptr_t>(B) % 16 == 0 && ldb % 4 == 0;
  j.epi = epi;
  j.tiles_n = static_cast<int>(cdiv(j.N, Eng::kBN));
  j.out_tiles = tiles_of(j.M, j.N, Eng::kBM, Eng::kBN);
  j.splits = p.split[i].splits;
  j.kc = p.split[i].kc;
  j.tiles = j.out_tiles * j.splits;
  if (j.splits > 1) {
    j.work = work;
    j.count = count;
    work += int64_t(j.tiles) * Eng::kBM * Eng::kBN;
    count += j.out_tiles;
  }
  return j;
}

// K3 or K4's plans and workspace: the counters (zeroed here, on the call's
// stream, so that a captured call zeroes its own) follow the partials
cudaError_t f32_setup(const Args<float>& a, bool bwd, LaunchPlan (&p)[2], unsigned*& count) {
  plans_of(a.B, a.din, a.hid, a.dout, bwd, p);
  int64_t floats, counters;
  f32_workspace(a.B, a.din, a.hid, a.dout, bwd, &floats, &counters);
  count = reinterpret_cast<unsigned*>(a.work + floats);
  if (counters == 0) return cudaSuccess;
  return cudaMemsetAsync(count, 0, counters * sizeof(unsigned), a.s);
}

template <class Run>
cudaError_t with_plan(const LaunchPlan& p, Run run) {
  if (p.big) return run(FfmaBig{});
  return run(FfmaSmall{});
}

cudaError_t fwd_f32(const Args<float>& a) {
  LaunchPlan p[2];
  unsigned* c;
  cudaError_t e = f32_setup(a, false, p, c);
  if (e != cudaSuccess) return e;
  e = with_plan(p[0], [&](auto eng) {
    using Eng = decltype(eng);
    float* w = a.work;
    return launch<Eng>(make_f32_job<Eng, false, false>(p[0], 0, a.x, a.w0, a.din, a.hid,
                                                       EpiBiasTanh<float>{a.b0, a.hout, a.hid},
                                                       w, c),
                       NoJob{0}, NoTail{0}, a.s);
  });
  if (e != cudaSuccess) return e;
  return with_plan(p[1], [&](auto eng) {
    using Eng = decltype(eng);
    float* w = a.work;
    return launch<Eng>(make_f32_job<Eng, false, false>(p[1], 0, a.hout, a.w1, a.hid, a.dout,
                                                       EpiBias<float>{a.b1, a.y, a.dout}, w, c),
                       NoJob{0}, NoTail{0}, a.s);
  });
}

cudaError_t bwd_f32(const Args<float>& a) {
  LaunchPlan p[2];
  unsigned* c;
  cudaError_t e = f32_setup(a, true, p, c);
  if (e != cudaSuccess) return e;
  float* p0 = a.part;                          // dz: one row per row tile
  float* p1 = a.part + cdiv(a.B, 64) * a.hid;  // g: one row per 64 rows
  const int64_t parts0 = cdiv(a.B, p[0].bm());
  // 1: dW1 (hid, dout) = h^T g and dz (B, hid) = (g W1^T)(1 - h^2); g's sums
  e = with_plan(p[0], [&](auto eng) {
    using Eng = decltype(eng);
    float* w = a.work;
    const auto dw1 = make_f32_job<Eng, true, false>(p[0], 0, a.h, a.g, a.hid, a.dout,
                                                    EpiStore<float>{a.dw1, a.dout}, w, c);
    const auto dz = make_f32_job<Eng, false, true>(p[0], 1, a.g, a.w1, a.dout, a.dout,
                                                   EpiDz<float>{a.h, a.dzc, a.hid, p0}, w, c);
    return launch<Eng>(dw1, dz, make_partials(a.g, a.B, a.dout, p1), a.s);
  });
  if (e != cudaSuccess) return e;
  // 2: dx (B, din) = dzc W0^T and dW0 (din, hid) = x^T dzc; db0, db1
  const float* dzc = a.dzc;
  return with_plan(p[1], [&](auto eng) {
    using Eng = decltype(eng);
    float* w = a.work;
    const auto dx = make_f32_job<Eng, false, true>(p[1], 0, dzc, a.w0, a.hid, a.hid,
                                                   EpiStore<float>{a.dx, a.din}, w, c);
    const auto dw0 = make_f32_job<Eng, true, false>(p[1], 1, a.x, dzc, a.din, a.hid,
                                                    EpiStore<float>{a.dw0, a.hid}, w, c);
    return launch<Eng>(dx, dw0,
                       make_finals<Eng, float>({p0, parts0, a.hid, a.db0},
                                               {p1, cdiv(a.B, 64), a.dout, a.db1}),
                       a.s);
  });
}

template <typename T, class Eng>  // simt, wmma
cudaError_t fwd_tiles(const Args<T>& a) {
  cudaError_t e = launch<Eng>(
      make_job<Eng, false, false>(a.x, a.w0, a.B, a.hid, a.din, a.din, a.hid,
                                  EpiBiasTanh<T>{a.b0, a.hout, a.hid}),
      NoJob{0}, NoTail{0}, a.s);
  if (e != cudaSuccess) return e;
  return launch<Eng>(
      make_job<Eng, false, false>(const_cast<const T*>(a.hout), a.w1, a.B, a.dout,
                                  a.hid, a.hid, a.dout,
                                  EpiBias<T>{a.b1, a.y, a.dout}),
      NoJob{0}, NoTail{0}, a.s);
}

template <typename T, class Eng>  // simt, wmma
cudaError_t bwd_tiles(const Args<T>& a) {
  using Acc = acc_t<T>;
  Acc* p0 = a.part;                                     // dz: one row per row tile
  Acc* p1 = a.part + cdiv(a.B, 64) * a.hid;             // g: one row per 64 rows
  // 1: dW1 (hid, dout) = h^T g and dz (B, hid) = (g W1^T)(1 - h^2); g's sums
  cudaError_t e = launch<Eng>(
      make_job<Eng, true, false>(a.h, a.g, a.hid, a.dout, a.B, a.hid, a.dout,
                                 EpiStore<T>{a.dw1, a.dout}),
      make_job<Eng, false, true>(a.g, a.w1, a.B, a.hid, a.dout, a.dout, a.dout,
                                 EpiDz<T>{a.h, a.dzc, a.hid, p0}),
      make_partials(a.g, a.B, a.dout, p1), a.s);
  if (e != cudaSuccess) return e;
  // 2: dx (B, din) = dzc W0^T and dW0 (din, hid) = x^T dzc; db0, db1
  const T* dzc = a.dzc;
  return launch<Eng>(
      make_job<Eng, false, true>(dzc, a.w0, a.B, a.din, a.hid, a.hid, a.hid,
                                 EpiStore<T>{a.dx, a.din}),
      make_job<Eng, true, false>(a.x, dzc, a.din, a.hid, a.B, a.din, a.hid,
                                 EpiStore<T>{a.dw0, a.hid}),
      make_finals<Eng, T>({p0, cdiv(a.B, Eng::kBM), a.hid, a.db0},
                          {p1, cdiv(a.B, 64), a.dout, a.db1}),
      a.s);
}

cudaError_t fwd_wgmma(const Args<bf16>& a) {
  cudaError_t e = with_wg_tile(
      [&](int bm, int bn) { return tiles_of(a.B, a.hid, bm, bn); },
      [&](auto eng) {
        using Eng = decltype(eng);
        WgJob<false, false, EpiBiasTanh<bf16>> j;
        const cudaError_t err = make_wg_job<Eng>(j, a.x, a.w0, a.B, a.hid, a.din,
                                         EpiBiasTanh<bf16>{a.b0, a.hout, a.hid});
        return err != cudaSuccess ? err : launch<Eng>(j, NoJob{0}, NoTail{0}, a.s);
      });
  if (e != cudaSuccess) return e;
  return with_wg_tile(
      [&](int bm, int bn) { return tiles_of(a.B, a.dout, bm, bn); },
      [&](auto eng) {
        using Eng = decltype(eng);
        WgJob<false, false, EpiBias<bf16>> j;
        const cudaError_t err = make_wg_job<Eng>(j, a.hout, a.w1, a.B, a.dout, a.hid,
                                         EpiBias<bf16>{a.b1, a.y, a.dout});
        return err != cudaSuccess ? err : launch<Eng>(j, NoJob{0}, NoTail{0}, a.s);
      });
}

cudaError_t bwd_wgmma(const Args<bf16>& a) {
  float* p0 = a.part;
  float* p1 = a.part + cdiv(a.B, 64) * a.hid;
  int64_t parts0 = 0;  // row tiles of launch 1's dz
  cudaError_t e = with_wg_tile(
      [&](int bm, int bn) {
        return tiles_of(a.hid, a.dout, bm, bn) + tiles_of(a.B, a.hid, bm, bn);
      },
      [&](auto eng) {
        using Eng = decltype(eng);
        parts0 = cdiv(a.B, Eng::kBM);
        WgJob<true, false, EpiStore<bf16>> dw1;
        WgJob<false, true, EpiDz<bf16>> dz;
        cudaError_t err = make_wg_job<Eng>(dw1, a.h, a.g, a.hid, a.dout, a.B,
                                         EpiStore<bf16>{a.dw1, a.dout});
        if (err == cudaSuccess)
          err = make_wg_job<Eng>(dz, a.g, a.w1, a.B, a.hid, a.dout,
                               EpiDz<bf16>{a.h, a.dzc, a.hid, p0});
        return err != cudaSuccess
                   ? err : launch<Eng>(dw1, dz, make_partials(a.g, a.B, a.dout, p1), a.s);
      });
  if (e != cudaSuccess) return e;
  return with_wg_tile(
      [&](int bm, int bn) {
        return tiles_of(a.B, a.din, bm, bn) + tiles_of(a.din, a.hid, bm, bn);
      },
      [&](auto eng) {
        using Eng = decltype(eng);
        WgJob<false, true, EpiStore<bf16>> dx;
        WgJob<true, false, EpiStore<bf16>> dw0;
        cudaError_t err = make_wg_job<Eng>(dx, a.dzc, a.w0, a.B, a.din, a.hid,
                                         EpiStore<bf16>{a.dx, a.din});
        if (err == cudaSuccess)
          err = make_wg_job<Eng>(dw0, a.x, a.dzc, a.din, a.hid, a.B,
                               EpiStore<bf16>{a.dw0, a.hid});
        return err != cudaSuccess
                   ? err : launch<Eng>(dx, dw0,
                                     make_finals<Eng, bf16>({p0, parts0, a.hid, a.db0},
                                                            {p1, cdiv(a.B, 64), a.dout, a.db1}),
                                     a.s);
      });
}

// the wgmma route's contract: TMA rows of a multiple of 16 bytes, 16-byte
// aligned bases (ops/mlp.py:mlp2_route checks it before launch)
bool wgmma_takes(const Args<bf16>& a, std::initializer_list<const void*> ptrs) {
  if (a.din % 8 || a.hid % 8 || a.dout % 8) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

template <typename T>
Args<T> fwd_args(const void* x, const void* w0, const void* b0, const void* w1,
                 const void* b1, void* y, void* h, void* work,
                 int64_t B, int64_t din, int64_t hid, int64_t dout, void* stream) {
  Args<T> a{};
  a.work = static_cast<float*>(work);
  a.x = static_cast<const T*>(x);
  a.w0 = static_cast<const T*>(w0);
  a.b0 = static_cast<const T*>(b0);
  a.w1 = static_cast<const T*>(w1);
  a.b1 = static_cast<const T*>(b1);
  a.y = static_cast<T*>(y);
  a.hout = static_cast<T*>(h);
  a.B = B;
  a.din = din;
  a.hid = hid;
  a.dout = dout;
  a.s = static_cast<cudaStream_t>(stream);
  return a;
}

template <typename T>
Args<T> bwd_args(const void* x, const void* w0, const void* w1, const void* h,
                 const void* g, void* dx, void* dw0, void* db0, void* dw1,
                 void* db1, void* dzc, void* part, void* work,
                 int64_t B, int64_t din, int64_t hid, int64_t dout, void* stream) {
  Args<T> a{};
  a.work = static_cast<float*>(work);
  a.x = static_cast<const T*>(x);
  a.w0 = static_cast<const T*>(w0);
  a.w1 = static_cast<const T*>(w1);
  a.h = static_cast<const T*>(h);
  a.g = static_cast<const T*>(g);
  a.dx = static_cast<T*>(dx);
  a.dw0 = static_cast<T*>(dw0);
  a.db0 = static_cast<T*>(db0);
  a.dw1 = static_cast<T*>(dw1);
  a.db1 = static_cast<T*>(db1);
  a.dzc = static_cast<T*>(dzc);
  a.part = static_cast<acc_t<T>*>(part);
  a.B = B;
  a.din = din;
  a.hid = hid;
  a.dout = dout;
  a.s = static_cast<cudaStream_t>(stream);
  return a;
}

inline int check_widths(int64_t B, int64_t din, int64_t hid, int64_t dout) {
  if (B <= 0 || din <= 0 || hid <= 0 || dout <= 0) return -1;  // nothing to do
  return widths_fit(B, din, hid, dout) ? 1 : 0;
}

// the float32 route's contract: a split plan gets its workspace
bool f32_takes(const Args<float>& a, bool bwd) {
  int64_t floats, counters;
  return a.work != nullptr ||
         f32_workspace(a.B, a.din, a.hid, a.dout, bwd, &floats, &counters) == 0;
}

}  // namespace

extern "C" {

// K3: y (B, dout), h (B, hid). K4: dx, dW0, db0, dW1, db1, with scratch dzc
// (B, hid) in the data type and part, cdiv(B, 64) (hid + dout) values in the
// accumulation type. work is the float32 route's split workspace
// (mlp2_simt_f32_workspace; null where it needs none), which the other
// routes do not read. Each returns 0 or a cudaError_t.
#define MLP2_ENTRY_POINTS(ROUTE, SUFFIX, T, FWD, BWD, TAKES_FWD, TAKES_BWD)      \
  int mlp2_fwd_##ROUTE##_##SUFFIX(const void* x, const void* w0, const void* b0, \
                                  const void* w1, const void* b1, void* y,       \
                                  void* h, void* work, int64_t B,                \
                                  int64_t din, int64_t hid, int64_t dout,        \
                                  void* stream) {                                \
    const int ok = check_widths(B, din, hid, dout);                              \
    if (ok <= 0) return ok < 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);   \
    const Args<T> a = fwd_args<T>(x, w0, b0, w1, b1, y, h, work, B, din, hid,   \
                                  dout, stream);                                 \
    if (!(TAKES_FWD)) return static_cast<int>(cudaErrorInvalidValue);            \
    return static_cast<int>(FWD(a));                                             \
  }                                                                              \
  int mlp2_bwd_##ROUTE##_##SUFFIX(                                               \
      const void* x, const void* w0, const void* w1, const void* h,              \
      const void* g, void* dx, void* dw0, void* db0, void* dw1, void* db1,       \
      void* dzc, void* part, void* work, int64_t B, int64_t din,                 \
      int64_t hid, int64_t dout, void* stream) {                                 \
    const int ok = check_widths(B, din, hid, dout);                              \
    if (ok <= 0) return ok < 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);   \
    const Args<T> a = bwd_args<T>(x, w0, w1, h, g, dx, dw0, db0, dw1, db1, dzc,  \
                                  part, work, B, din, hid, dout, stream);        \
    if (!(TAKES_BWD)) return static_cast<int>(cudaErrorInvalidValue);            \
    return static_cast<int>(BWD(a));                                             \
  }

MLP2_ENTRY_POINTS(simt, f32, float, fwd_f32, bwd_f32, f32_takes(a, false),
                  f32_takes(a, true))
MLP2_ENTRY_POINTS(simt, f64, double, (fwd_tiles<double, Simt<double>>),
                  (bwd_tiles<double, Simt<double>>), true, true)
MLP2_ENTRY_POINTS(wmma, bf16, bf16, (fwd_tiles<bf16, Wmma>),
                  (bwd_tiles<bf16, Wmma>), true, true)
MLP2_ENTRY_POINTS(wgmma, bf16, bf16, fwd_wgmma, bwd_wgmma,
                  wgmma_takes(a, {x, w0, b0, w1, b1, y, h}),
                  wgmma_takes(a, {x, w0, w1, h, g, dx, dw0, db0, dw1, db1, dzc, part}))

#undef MLP2_ENTRY_POINTS

// The float32 route's split workspace for K3 (bwd = 0) or K4 (bwd = 1) at
// these widths on the current device, in 4-byte words (a float32 buffer,
// new each call: the launcher zeroes the counters in it); 0 where the plan
// splits nothing.
int64_t mlp2_simt_f32_workspace(int64_t B, int64_t din, int64_t hid, int64_t dout, int bwd) {
  if (check_widths(B, din, hid, dout) <= 0) return 0;
  int64_t floats, counters;
  return f32_workspace(B, din, hid, dout, bwd != 0, &floats, &counters);
}

}  // extern "C"
