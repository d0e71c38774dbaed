// S-step RK4 block of the 1-D reaction-diffusion field (K5) and its exact
// discrete pullback (K6), for Hopper (sm_90a).
//
//   f(x)_j = Dc * L(x)_j + k * x_j * (1 - x_j),   Dc = D * inv_dx2, p = [D, k]
//   RK4:  k1 = f(u), k2 = f(u + h/2 k1), k3 = f(u + h/2 k2), k4 = f(u + h k3),
//         u <- u + h/6 (k1 + 2 (k2 + k3) + k4)
//
// Blocking, shared by both kernels. Block i owns the interior tile
// [i*C, (i+1)*C) and reads the window [start, start + W) of u by offset,
// start = clamp(i*C - H, 0, n - W), W = C + 2H, H = 4(S+1) (one tile, C = n,
// has H = 0). Inside the window L uses the edge-copy ghost at the window's
// own edges, as the TPU kernels do: the wrong values this puts next to an
// inner window edge travel at most 4 cells per RK4 step, so after S steps
// they stay in the halo, and the block writes only its C interior cells, at
// window offset i*C - start. The window lives in dynamic shared memory
// through every stage (above 48 KB after cudaFuncSetAttribute). Each stage
// is one loop of the block over the window's cells and one __syncthreads():
// the stage reads its input's stencil and writes the next stage's input to
// another buffer, so no cell is overwritten while a neighbour reads it.
//
// K5 rd1d_rk4_fwd_kernel replaces the Pallas kernel
//    scimlsensitivity_jl_tpu/ops/pallas_pde.py:_rk4_fwd_kernel_factory (via
//    make_rd1d_rk4_block -> _block_fwd). No window gather pass and no 3-way
//    slice switch: the block reads and writes by offset. Five window arrays
//    (state, two ping-pong stage inputs, k1, k2 + k3). Bound by operations
//    on this card: 44 flops per cell per step against 8 bytes per float32
//    cell per launch (u read, u written), so at S = 16 about 16*44/8 = 88
//    flops per byte, above the H100's 67e12 / 3.35e12 = 20. The design
//    keeps all 4*S stages out of device memory; the shared-memory traffic of
//    the stencils is what a later, register-blocked version would cut.
//
// K6 rd1d_rk4_bwd_kernel + rd1d_rk4_bwd_reduce_kernel replace
//    scimlsensitivity_jl_tpu/ops/pallas_pde.py:_rk4_bwd_kernel_factory (via
//    block_bwd_rule): the exact discrete adjoint of the S-step block. Per
//    reverse step, with J(x)^T v = Dc * L(v) + k (1 - 2x) v (L is symmetric):
//      w4 = h/6 lam;            s4 = J(u4)^T w4
//      w3 = 2h/6 lam + h s4;    s3 = J(u3)^T w3
//      w2 = 2h/6 lam + h/2 s3;  s2 = J(u2)^T w2
//      w1 = h/6 lam + h/2 s2;   s1 = J(u)^T w1
//      lam <- lam + s1 + s2 + s3 + s4
//      dD += (L w_i) u_i,  dk += w_i u_i (1 - u_i)   over the interior tile
//    It is the exact adjoint of the windowed map. Against the whole grid it
//    differs, as the TPU kernel's does, by terms of order (h*Dc)^(2S+2):
//    the edge-copy ghost perturbs the recomputed stage states near an inner
//    window edge, and the reverse sweep reaches them in 2S + 2 stencil hops.
//    The stage cache: the TPU kernel keeps all 4*S*W stage states in VMEM,
//    4.2 MB per program at its tile, which no block of this card can hold.
//    This kernel keeps only the S step-entry states (S*W values): it re-steps
//    the window once from u to fill them, and the reverse sweep recomputes
//    the stage states u2, u3, u4 of step s from its entry state (three
//    field evaluations) when it reaches s. With 4 stage buffers, the sum
//    s4 + s3 + s2 and lam, that is (S + 6)*W values: W = 1160 (a tile of
//    1024 at S = 16) is 102 KB in float32 and 204 KB in float64. Keeping
//    all 4 stages instead would leave W ~ 800 (20% of the cells halo), and
//    a cache in device memory would move ~270 MB per launch at n = 2^20.
//    Bound by operations: the function's own work is 44 flops per cell per
//    step for the stage states and 74 for the reverse sweep, against 12
//    bytes per float32 cell (u, lam read, du written); the recomputation
//    (S - 1 re-steps plus 3 field evaluations per reverse step) is the
//    design's, paid in arithmetic to stay in shared memory. dD and dk are
//    summed per thread over the interior cells, then per block in a fixed
//    tree, and a second one-block pass sums the per-block partials in a
//    fixed order: no atomics, the same bits every run.
//
// Both kernels read D and k from the device vector p, take h and inv_dx2 as
// arguments, launch on the caller's stream, never synchronise, allocate
// nothing, and the launchers return cudaGetLastError() (or
// cudaErrorInvalidValue for a window larger than the card's shared memory,
// which the Python wrapper checks first).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;         // threads per block of both kernels
constexpr int kReduceThreads = 1024;  // threads of the one-block reduction
constexpr int kFwdArrays = 5;         // K5: window arrays in shared memory
constexpr int kBwdExtraArrays = 6;    // K6: arrays beside the S entry states

// Window-local Laplacian with the edge-copy ghost at the window's edges.
template <typename T>
__device__ __forceinline__ T lap_w(const T* x, int j, int W) {
  const T xl = x[j > 0 ? j - 1 : 0];
  const T xr = x[j + 1 < W ? j + 1 : W - 1];
  return (xl - T(2) * x[j]) + xr;
}

template <typename T>
__device__ __forceinline__ T field_at(const T* x, int j, int W, T Dc, T k) {
  const T xj = x[j];
  return Dc * lap_w(x, j, W) + k * xj * (T(1) - xj);
}

// L(c * x)_j, with c * x formed at each of the three cells as the TPU kernel
// forms w4 = h/6 lam before its Laplacian.
template <typename T>
__device__ __forceinline__ T lap_scaled(const T* x, T c, int j, int W) {
  const T xl = c * x[j > 0 ? j - 1 : 0];
  const T xr = c * x[j + 1 < W ? j + 1 : W - 1];
  return (xl - T(2) * (c * x[j])) + xr;
}

struct Coeffs {
  double h, hh, h6, h26;  // h, h/2, h/6, 2h/6
};

Coeffs coeffs(double h) { return {h, 0.5 * h, h / 6.0, 2.0 * h / 6.0}; }

// One RK4 step of the window: uo = step(ui). uo may be ui. xa, xb, k1s, k23
// are scratch. Every thread may read ui on entry and uo on exit.
template <typename T>
__device__ void rk4_step(const T* ui, T* uo, T* xa, T* xb, T* k1s, T* k23,
                         int W, T Dc, T k, T h, T hh, T h6) {
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    const T k1 = field_at(ui, j, W, Dc, k);
    k1s[j] = k1;
    xa[j] = ui[j] + hh * k1;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    const T k2 = field_at(xa, j, W, Dc, k);
    k23[j] = k2;
    xb[j] = ui[j] + hh * k2;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    const T k3 = field_at(xb, j, W, Dc, k);
    k23[j] = k23[j] + k3;
    xa[j] = ui[j] + h * k3;  // xa's stage-2 readers are past the barrier
  }
  __syncthreads();
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    const T k4 = field_at(xa, j, W, Dc, k);
    // only this thread reads ui[j] in this stage, so uo may alias ui
    uo[j] = ui[j] + h6 * (k1s[j] + T(2) * k23[j] + k4);
  }
  __syncthreads();
}

__device__ __forceinline__ int64_t window_start(int64_t i, int64_t n, int C,
                                                int H, int W) {
  int64_t start = i * C - H;
  if (start > n - W) start = n - W;
  if (start < 0) start = 0;
  return start;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rd1d_rk4_fwd_kernel(const T* __restrict__ u, const T* __restrict__ p,
                    T inv_dx2, T h, T hh, T h6, T* __restrict__ out,
                    int64_t n, int S, int C, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* su = reinterpret_cast<T*>(smem_raw);
  T* xa = su + W;
  T* xb = xa + W;
  T* k1s = xb + W;
  T* k23 = k1s + W;
  const int64_t i = blockIdx.x;
  const int64_t start = window_start(i, n, C, H, W);
  const int off = static_cast<int>(i * C - start);
  const T Dc = p[0] * inv_dx2;
  const T k = p[1];
  for (int j = threadIdx.x; j < W; j += blockDim.x) su[j] = u[start + j];
  __syncthreads();
  for (int s = 0; s < S; ++s) {
    rk4_step(su, su, xa, xb, k1s, k23, W, Dc, k, h, hh, h6);
  }
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    out[i * C + c] = su[off + c];
  }
}

// Sum of v over the block in a fixed order (warp shuffles, then warp 0),
// valid in thread 0. red holds one value per warp.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  T total = T(0);
  if (threadIdx.x == 0) {
    for (int w = 0; w < (blockDim.x + 31) / 32; ++w) total += red[w];
  }
  __syncthreads();
  return total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rd1d_rk4_bwd_kernel(const T* __restrict__ u, const T* __restrict__ p,
                    const T* __restrict__ lam, T inv_dx2, T h, T hh, T h6,
                    T h26, T* __restrict__ du, T* __restrict__ partials,
                    int64_t n, int S, int C, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[kThreads / 32];
  T* ust = reinterpret_cast<T*>(smem_raw);  // S entry states of W cells
  T* lm = ust + static_cast<int64_t>(S) * W;
  T* A = lm + W;   // u2 (stages a..e)
  T* B = A + W;    // u3 (b..d), then w1 (e..f)
  T* Cc = B + W;   // w3 (c..d)
  T* Dd = Cc + W;  // w2 (d..e)
  T* ss = Dd + W;  // s4 + s3 + s2, one cell per thread
  const int64_t i = blockIdx.x;
  const int64_t start = window_start(i, n, C, H, W);
  const int off = static_cast<int>(i * C - start);
  const T Dc = p[0] * inv_dx2;
  const T k = p[1];
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    ust[j] = u[start + j];
    lm[j] = lam[start + j];
  }
  __syncthreads();
  for (int s = 0; s + 1 < S; ++s) {
    rk4_step(ust + static_cast<int64_t>(s) * W,
             ust + static_cast<int64_t>(s + 1) * W, A, B, Cc, Dd, W, Dc, k,
             h, hh, h6);
  }
  T tD = T(0);  // this thread's share of sum (L w_i) u_i over interior cells
  T tk = T(0);  // ... of sum w_i u_i (1 - u_i)
  for (int s = S - 1; s >= 0; --s) {
    const T* U = ust + static_cast<int64_t>(s) * W;
    for (int j = threadIdx.x; j < W; j += blockDim.x) {  // (a) u2
      A[j] = U[j] + hh * field_at(U, j, W, Dc, k);
    }
    __syncthreads();
    for (int j = threadIdx.x; j < W; j += blockDim.x) {  // (b) u3
      B[j] = U[j] + hh * field_at(A, j, W, Dc, k);
    }
    __syncthreads();
    for (int j = threadIdx.x; j < W; j += blockDim.x) {  // (c) u4, s4, w3
      const T u4 = U[j] + h * field_at(B, j, W, Dc, k);
      const T w4 = h6 * lm[j];
      const T lw4 = lap_scaled(lm, h6, j, W);
      const T s4 = Dc * lw4 + k * (T(1) - T(2) * u4) * w4;
      Cc[j] = h26 * lm[j] + h * s4;
      ss[j] = s4;
      if (j >= off && j < off + C) {
        tD += lw4 * u4;
        tk += w4 * u4 * (T(1) - u4);
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < W; j += blockDim.x) {  // (d) s3, w2
      const T u3 = B[j];
      const T w3 = Cc[j];
      const T lw3 = lap_w(Cc, j, W);
      const T s3 = Dc * lw3 + k * (T(1) - T(2) * u3) * w3;
      Dd[j] = h26 * lm[j] + hh * s3;
      ss[j] = ss[j] + s3;
      if (j >= off && j < off + C) {
        tD += lw3 * u3;
        tk += w3 * u3 * (T(1) - u3);
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < W; j += blockDim.x) {  // (e) s2, w1
      const T u2 = A[j];
      const T w2 = Dd[j];
      const T lw2 = lap_w(Dd, j, W);
      const T s2 = Dc * lw2 + k * (T(1) - T(2) * u2) * w2;
      B[j] = h6 * lm[j] + hh * s2;  // u3's last reader was stage (d)
      ss[j] = ss[j] + s2;
      if (j >= off && j < off + C) {
        tD += lw2 * u2;
        tk += w2 * u2 * (T(1) - u2);
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < W; j += blockDim.x) {  // (f) s1, lam
      const T u1 = U[j];
      const T w1 = B[j];
      const T lw1 = lap_w(B, j, W);
      const T s1 = Dc * lw1 + k * (T(1) - T(2) * u1) * w1;
      lm[j] = (lm[j] + s1) + ss[j];  // lam is read by neighbours only in (c)
      if (j >= off && j < off + C) {
        tD += lw1 * u1;
        tk += w1 * u1 * (T(1) - u1);
      }
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < C; c += blockDim.x) du[i * C + c] = lm[off + c];
  const T sD = block_sum(tD, red);
  const T sk = block_sum(tk, red);
  if (threadIdx.x == 0) {
    partials[2 * i] = sD;
    partials[2 * i + 1] = sk;
  }
}

template <typename T>
__global__ void rd1d_rk4_bwd_reduce_kernel(const T* __restrict__ partials,
                                           int64_t n_blocks, T inv_dx2,
                                           T* __restrict__ dp) {
  __shared__ T s_dD[kReduceThreads];
  __shared__ T s_dk[kReduceThreads];
  T dD = T(0);
  T dk = T(0);
  for (int64_t b = threadIdx.x; b < n_blocks; b += blockDim.x) {
    dD += partials[2 * b];
    dk += partials[2 * b + 1];
  }
  s_dD[threadIdx.x] = dD;
  s_dk[threadIdx.x] = dk;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      s_dD[threadIdx.x] += s_dD[threadIdx.x + s];
      s_dk[threadIdx.x] += s_dk[threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    dp[0] = inv_dx2 * s_dD[0];
    dp[1] = s_dk[0];
  }
}

int64_t fwd_smem(int W, int elt) {
  return static_cast<int64_t>(kFwdArrays) * W * elt;
}

int64_t bwd_smem(int W, int S, int elt) {
  return (static_cast<int64_t>(S) + kBwdExtraArrays) * W * elt;
}

int64_t smem_limit() {
  int dev = 0;
  int limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return 0;
  }
  return limit;
}

int64_t num_tiles(int64_t n, int C) { return (n + C - 1) / C; }

template <typename T>
int launch_fwd(const void* u, const void* p, double inv_dx2, double h,
               void* out, int64_t n, int S, int C, int H, int W,
               void* stream) {
  if (n <= 0) return 0;
  const int64_t smem = fwd_smem(W, sizeof(T));
  if (smem > smem_limit()) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      rd1d_rk4_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Coeffs c = coeffs(h);
  rd1d_rk4_fwd_kernel<T><<<static_cast<unsigned>(num_tiles(n, C)), kThreads,
                           static_cast<size_t>(smem),
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const T*>(p),
      static_cast<T>(inv_dx2), static_cast<T>(c.h), static_cast<T>(c.hh),
      static_cast<T>(c.h6), static_cast<T*>(out), n, S, C, H, W);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* u, const void* p, const void* lam, double inv_dx2,
               double h, void* du, void* partials, void* dp, int64_t n, int S,
               int C, int H, int W, void* stream) {
  if (n <= 0) return 0;
  const int64_t smem = bwd_smem(W, S, sizeof(T));
  if (smem > smem_limit()) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      rd1d_rk4_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Coeffs c = coeffs(h);
  const int64_t tiles = num_tiles(n, C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rd1d_rk4_bwd_kernel<T><<<static_cast<unsigned>(tiles), kThreads,
                           static_cast<size_t>(smem), s>>>(
      static_cast<const T*>(u), static_cast<const T*>(p),
      static_cast<const T*>(lam), static_cast<T>(inv_dx2),
      static_cast<T>(c.h), static_cast<T>(c.hh), static_cast<T>(c.h6),
      static_cast<T>(c.h26), static_cast<T*>(du), static_cast<T*>(partials),
      n, S, C, H, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rd1d_rk4_bwd_reduce_kernel<T><<<1, kReduceThreads, 0, s>>>(
      static_cast<const T*>(partials), tiles, static_cast<T>(inv_dx2),
      static_cast<T*>(dp));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory of one K5 / K6 block for a window of W cells.
int64_t rd1d_rk4_fwd_smem_bytes(int W, int S, int elt) {
  (void)S;
  return fwd_smem(W, elt);
}

int64_t rd1d_rk4_bwd_smem_bytes(int W, int S, int elt) {
  return bwd_smem(W, S, elt);
}

// The current device's opt-in limit of dynamic shared memory per block.
int64_t rd1d_rk4_smem_limit(void) { return smem_limit(); }

int rd1d_rk4_fwd_f32(const void* u, const void* p, double inv_dx2, double h,
                     void* out, int64_t n, int S, int C, int H, int W,
                     void* stream) {
  return launch_fwd<float>(u, p, inv_dx2, h, out, n, S, C, H, W, stream);
}

int rd1d_rk4_fwd_f64(const void* u, const void* p, double inv_dx2, double h,
                     void* out, int64_t n, int S, int C, int H, int W,
                     void* stream) {
  return launch_fwd<double>(u, p, inv_dx2, h, out, n, S, C, H, W, stream);
}

int rd1d_rk4_bwd_f32(const void* u, const void* p, const void* lam,
                     double inv_dx2, double h, void* du, void* partials,
                     void* dp, int64_t n, int S, int C, int H, int W,
                     void* stream) {
  return launch_bwd<float>(u, p, lam, inv_dx2, h, du, partials, dp, n, S, C,
                           H, W, stream);
}

int rd1d_rk4_bwd_f64(const void* u, const void* p, const void* lam,
                     double inv_dx2, double h, void* du, void* partials,
                     void* dp, int64_t n, int S, int C, int H, int W,
                     void* stream) {
  return launch_bwd<double>(u, p, lam, inv_dx2, h, du, partials, dp, n, S, C,
                            H, W, stream);
}

}  // extern "C"
