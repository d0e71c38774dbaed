// 1-D reaction-diffusion field and its fused pullback, for Hopper (sm_90a).
//
//   f_i = D * inv_dx2 * L(u)_i + k * u_i * (1 - u_i)
//   L(u)_i = u_{i-1} - 2 u_i + u_{i+1}, with an edge-copy ghost cell:
//   L(u)_0 = u_1 - u_0 and L(u)_{n-1} = u_{n-2} - u_{n-1}. L is symmetric.
//
// K1 rd1d_fwd_kernel replaces the Pallas kernel
//    scimlsensitivity_jl_tpu/ops/pallas_pde.py:_fwd_kernel (via _rd_fwd).
//    One thread per cell, neighbours read with clamped indices (the edge
//    copy). Bound by memory bandwidth: 2 streams of n values (u read, f
//    written; the +-1 neighbour loads hit L1/L2), i.e. 8 bytes per cell in
//    float32 and 16 in float64. The design reads each value once from
//    device memory and keeps the stencil in registers.
//
// K2 rd1d_bwd_kernel + rd1d_bwd_reduce_kernel replace
//    scimlsensitivity_jl_tpu/ops/pallas_pde.py:_bwd_kernel (via
//    _rd_bwd_rule):
//      du_i = D * inv_dx2 * L(lam)_i + k * (1 - 2 u_i) * lam_i
//      dD   = inv_dx2 * sum_i lam_i * L(u)_i
//      dk   = sum_i lam_i * u_i * (1 - u_i)
//    Bound by memory bandwidth: 3 streams (u and lam read, du written), 12
//    bytes per cell in float32, 24 in float64. The TPU kernel carries the
//    sums through one sequential grid; here blocks run in any order, so the
//    first pass writes one (dD, dk) partial per block, reduced in shared
//    memory, and a second one-block pass sums the partials in a fixed
//    order. No atomics: the result is the same from run to run.
//
// D and k are read from the device vector p = [D, k] inside the kernels, so
// no launch waits on a host read. Every launcher uses the caller's stream,
// never synchronises, allocates nothing, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;         // threads per block of the cell passes
constexpr int kReduceThreads = 1024;  // threads of the one-block reduction

template <typename T>
__device__ __forceinline__ T lap_at(const T* __restrict__ x, int64_t i,
                                    int64_t n) {
  const T xl = x[i > 0 ? i - 1 : 0];
  const T xr = x[i + 1 < n ? i + 1 : n - 1];
  return (xl - T(2) * x[i]) + xr;
}

template <typename T>
__global__ void rd1d_fwd_kernel(const T* __restrict__ u,
                                const T* __restrict__ p, T inv_dx2,
                                T* __restrict__ f, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T D = p[0];
  const T k = p[1];
  const T ui = u[i];
  f[i] = D * inv_dx2 * lap_at(u, i, n) + k * ui * (T(1) - ui);
}

// In-place tree sum of two shared arrays of blockDim.x (a power of two).
template <typename T>
__device__ __forceinline__ void block_sum2(T* a, T* b) {
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      a[threadIdx.x] += a[threadIdx.x + s];
      b[threadIdx.x] += b[threadIdx.x + s];
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void rd1d_bwd_kernel(const T* __restrict__ u,
                                const T* __restrict__ p,
                                const T* __restrict__ lam, T inv_dx2,
                                T* __restrict__ du, T* __restrict__ partials,
                                int64_t n) {
  __shared__ T s_dD[kThreads];
  __shared__ T s_dk[kThreads];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  T dD = T(0);
  T dk = T(0);
  if (i < n) {
    const T D = p[0];
    const T k = p[1];
    const T ui = u[i];
    const T li = lam[i];
    du[i] = D * inv_dx2 * lap_at(lam, i, n) + k * (T(1) - T(2) * ui) * li;
    dD = li * lap_at(u, i, n);
    dk = li * ui * (T(1) - ui);
  }
  s_dD[threadIdx.x] = dD;
  s_dk[threadIdx.x] = dk;
  __syncthreads();
  block_sum2(s_dD, s_dk);
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = s_dD[0];
    partials[2 * blockIdx.x + 1] = s_dk[0];
  }
}

template <typename T>
__global__ void rd1d_bwd_reduce_kernel(const T* __restrict__ partials,
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
  block_sum2(s_dD, s_dk);
  if (threadIdx.x == 0) {
    dp[0] = inv_dx2 * s_dD[0];
    dp[1] = s_dk[0];
  }
}

int64_t num_blocks(int64_t n) { return (n + kThreads - 1) / kThreads; }

template <typename T>
int launch_fwd(const void* u, const void* p, double inv_dx2, void* f,
               int64_t n, void* stream) {
  if (n <= 0) return 0;
  rd1d_fwd_kernel<T><<<static_cast<unsigned>(num_blocks(n)), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const T*>(p),
      static_cast<T>(inv_dx2), static_cast<T*>(f), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* u, const void* p, const void* lam, double inv_dx2,
               void* du, void* partials, void* dp, int64_t n, void* stream) {
  if (n <= 0) return 0;
  const int64_t blocks = num_blocks(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rd1d_bwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const T*>(u), static_cast<const T*>(p),
      static_cast<const T*>(lam), static_cast<T>(inv_dx2),
      static_cast<T*>(du), static_cast<T*>(partials), n);
  const cudaError_t first = cudaGetLastError();
  if (first != cudaSuccess) return static_cast<int>(first);
  rd1d_bwd_reduce_kernel<T><<<1, kReduceThreads, 0, s>>>(
      static_cast<const T*>(partials), blocks, static_cast<T>(inv_dx2),
      static_cast<T*>(dp));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Number of (dD, dk) partial pairs K2's first pass writes for n cells.
int64_t rd1d_bwd_num_partials(int64_t n) { return n > 0 ? num_blocks(n) : 0; }

int rd1d_fwd_f32(const void* u, const void* p, double inv_dx2, void* f,
                 int64_t n, void* stream) {
  return launch_fwd<float>(u, p, inv_dx2, f, n, stream);
}

int rd1d_fwd_f64(const void* u, const void* p, double inv_dx2, void* f,
                 int64_t n, void* stream) {
  return launch_fwd<double>(u, p, inv_dx2, f, n, stream);
}

int rd1d_bwd_f32(const void* u, const void* p, const void* lam,
                 double inv_dx2, void* du, void* partials, void* dp,
                 int64_t n, void* stream) {
  return launch_bwd<float>(u, p, lam, inv_dx2, du, partials, dp, n, stream);
}

int rd1d_bwd_f64(const void* u, const void* p, const void* lam,
                 double inv_dx2, void* du, void* partials, void* dp,
                 int64_t n, void* stream) {
  return launch_bwd<double>(u, p, lam, inv_dx2, du, partials, dp, n, stream);
}

}  // extern "C"
