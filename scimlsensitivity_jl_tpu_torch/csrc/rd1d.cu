// 1-D reaction-diffusion field and its fused pullback, for Hopper (sm_90a).
//
//   f_i = Dc * L(u)_i + k * u_i * (1 - u_i),   Dc = D * inv_dx2, p = [D, k]
//   L(u)_i = u_{i-1} - 2 u_i + u_{i+1}, with an edge-copy ghost cell:
//   L(u)_0 = u_1 - u_0 and L(u)_{n-1} = u_{n-2} - u_{n-1}. L is symmetric.
//
// K1 rd1d_fwd_kernel replaces the Pallas kernel
//    scimlsensitivity_jl_tpu/ops/pallas_pde.py:_fwd_kernel (via _rd_fwd).
// K2 rd1d_bwd_kernel replaces
//    scimlsensitivity_jl_tpu/ops/pallas_pde.py:_bwd_kernel (via
//    _rd_bwd_rule):
//      du_i = Dc * L(lam)_i + k * (1 - 2 u_i) * lam_i
//      dD   = inv_dx2 * sum_i lam_i * L(u)_i
//      dk   = sum_i lam_i * u_i * (1 - u_i)
//
// Both are bound by memory bandwidth: K1 moves 2 streams of n values (u
// read, f written), 8 bytes per float32 cell and 16 per float64; K2 moves 3
// (u and lam read, du written), 12 and 24 bytes. The design moves each value
// once, in as few instructions as the card allows:
//
// Vector layout. Every access is a 16-byte vector (float4, or double2: V =
// 4 or 2 cells). Cells [0, h) before the first 16-byte boundary of u are the
// scalar head, the body [h, h + V*nv) is nv vectors, and the last < V cells
// are the scalar tail. Lane l of warp w handles the vectors
// (w*kVecs + j)*32 + l, j < kVecs, so each of a warp's loads reads 512
// contiguous bytes and a thread keeps kVecs vectors in flight. The outputs
// must share u's address modulo 16 (the wrapper allocates them so), and for
// K2 so must lam; where lam does not, the wrapper launches K2's V = 1
// instantiation, the same kernel on single cells.
//
// Neighbours. A vector's left ghost is the last cell of the lane before,
// its right ghost the first cell of the lane after, by __shfl_up_sync /
// __shfl_down_sync. Only lane 0, lane 31 and the lanes at the body's ends
// load one extra scalar (from L2: a neighbouring warp reads that sector),
// with the index clamped to [0, n) for the edge copy. The head and tail
// cells (at most 2V - 2) go through the scalar stencil in block 0's first
// two threads. Tiny n (no whole vector) is all head and tail.
//
// K2's sums. Each thread sums lam * L(u) and lam * u * (1 - u) over its
// kVecs*V cells in registers, in T; from there on in float64, for either
// type, since the sums cancel (terms of either sign) and float32 partials
// of 2^20 cells lose digits of the result; it costs two conversions per
// thread. A warp adds its lanes by a fixed __shfl_xor_sync butterfly (both
// sums at one shuffle per level), a block its warps' sums through shared
// memory after one barrier. The grid's sum finishes in the same launch,
// without read-modify-write atomics or fences: each block stores its
// (dD, dk) partial into its own two 64-bit slots of a workspace, which hold
// an "empty" NaN pattern before; the grid's last block polls the slots
// (thread t takes t, t + kThreads, ..., four in flight) until each holds a
// value, sums them in block-index order, empties them for the next launch
// and writes dp = [inv_dx2 * dD, dk]. Every store and poll of a slot is a
// relaxed gpu-scope atomic (st/ld.relaxed.gpu): a slot is one 64-bit word
// that holds either "empty" or the whole value, so the reader needs no
// ordering beyond the coherence of one location. Only that block waits,
// and only on blocks that never wait, so no schedule deadlocks; a wait of
// 10 s traps. The order of the sum is fixed: the same bits every run. A
// block stores its du vectors after its partial, which the last block
// waits on. The wrapper keeps the slots per (device, stream, dtype, block
// count), so a call allocates only du and dp. (A ticket from an atomic
// counter after a __threadfence() took 0.3-0.6 us longer per call:
// PERF.md.)
//
// A sharded state. On a state split over the ranks of a process group each
// rank launches K1/K2 on its own shard, and the cells beside the shard's
// ends are its neighbours' edge cells, not the edge copy. The wrapper passes
// them in a small device buffer, `gh`: [left, right] of u for K1, then of
// lam for K2. Only the loads at the shard's two ends change: the clamped
// index of `ghosts` and `lap_at` becomes a read of gh there. A null gh keeps
// the edge copy and today's bits. The shard is not copied into a haloed
// buffer: K1 and K2 stream 8 and 12 bytes per float32 cell, and a copy
// would add a pass over the shard.
//
// D and k are read from the device vector p, once per thread, so no launch
// waits on a host read. Every launcher uses the caller's stream, never
// synchronises, allocates nothing, and returns cudaGetLastError() (or
// cudaErrorMisalignedAddress for operands the vector layout cannot take).
//
// Both kernels run kThreads threads per block, each on kVecs vectors: the
// card's best of the settings tried (PERF.md §6).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kVecs = 2;
constexpr int kWarps = kThreads / 32;  // K2's block sum: a power of 2, <= 16

// The cell left of x's cell 0 and right of its cell n - 1: the edge copy,
// or a shard's ghosts g = [left, right] when g is not null.
template <typename T>
__device__ __forceinline__ T left_of_start(const T* __restrict__ x,
                                           const T* __restrict__ g) {
  return g ? g[0] : x[0];
}

template <typename T>
__device__ __forceinline__ T right_of_end(const T* __restrict__ x,
                                          const T* __restrict__ g,
                                          int64_t n) {
  return g ? g[1] : x[n - 1];
}

// The scalar stencil (head and tail cells).
template <typename T>
__device__ __forceinline__ T lap_at(const T* __restrict__ x, int64_t i,
                                    int64_t n, const T* __restrict__ g) {
  const T xl = i > 0 ? x[i - 1] : left_of_start(x, g);
  const T xr = i + 1 < n ? x[i + 1] : right_of_end(x, g, n);
  return (xl - T(2) * x[i]) + xr;
}

// V cells from p, one 16-byte load when V * sizeof(T) == 16.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, T (&x)[V]) {
  if constexpr (V * sizeof(T) == 16 && sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if constexpr (V * sizeof(T) == 16 && sizeof(T) == 8) {
    const double2 v = *reinterpret_cast<const double2*>(p);
    x[0] = v.x; x[1] = v.y;
  } else {
#pragma unroll
    for (int c = 0; c < V; ++c) x[c] = p[c];
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const T (&x)[V]) {
  if constexpr (V * sizeof(T) == 16 && sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (V * sizeof(T) == 16 && sizeof(T) == 8) {
    *reinterpret_cast<double2*>(p) = make_double2(x[0], x[1]);
  } else {
#pragma unroll
    for (int c = 0; c < V; ++c) p[c] = x[c];
  }
}

// Head cells (before the first 16-byte boundary of u) and vectors of the
// body; the tail starts at h + V * nv.
template <typename T, int V>
struct Layout {
  int64_t h, nv;
  __device__ __forceinline__ Layout(const T* u, int64_t n) {
    const int64_t head =
        V == 1 ? 0
               : static_cast<int64_t>((16u - (reinterpret_cast<uintptr_t>(u) &
                                              15u)) & 15u) / sizeof(T);
    h = head < n ? head : n;
    nv = (n - h) / V;
  }
};

// x's left and right ghosts for the vector vi starting at cell i0: from the
// neighbouring lanes, or loaded by the lanes at a warp's or the body's ends
// (at x's own ends, the edge copy or the shard's ghosts g).
template <typename T, int V>
__device__ __forceinline__ void ghosts(const T* __restrict__ x_glob,
                                       const T (&x)[V], int lane, int64_t vi,
                                       int64_t nv, int64_t i0, int64_t n,
                                       bool active, const T* __restrict__ g,
                                       T& left, T& right) {
  left = __shfl_up_sync(kFull, x[V - 1], 1);
  right = __shfl_down_sync(kFull, x[0], 1);
  if (active && lane == 0)
    left = i0 > 0 ? x_glob[i0 - 1] : left_of_start(x_glob, g);
  if (active && (lane == 31 || vi + 1 == nv))
    right = i0 + V < n ? x_glob[i0 + V] : right_of_end(x_glob, g, n);
}

template <typename T, int V>
__device__ __forceinline__ void lap_vec(const T (&x)[V], T left, T right,
                                        T (&lx)[V]) {
#pragma unroll
  for (int c = 0; c < V; ++c) {
    const T xl = c > 0 ? x[c - 1] : left;
    const T xr = c + 1 < V ? x[c + 1] : right;
    lx[c] = (xl - T(2) * x[c]) + xr;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    rd1d_fwd_kernel(const T* __restrict__ u, const T* __restrict__ p,
                    T inv_dx2, T* __restrict__ f, int64_t n,
                    const T* __restrict__ gh) {
  const T Dc = p[0] * inv_dx2;
  const T k = p[1];
  const Layout<T, V> g(u, n);
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;

  // every load of the thread first, then the stencil
  T x[kVecs][V], left[kVecs], right[kVecs];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int64_t vi = (warp * kVecs + j) * 32 + lane;
    if (vi < g.nv) {
      load_vec<T, V>(u + g.h + vi * V, x[j]);
    } else {
#pragma unroll
      for (int c = 0; c < V; ++c) x[j][c] = T(0);
    }
  }
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int64_t vi = (warp * kVecs + j) * 32 + lane;
    ghosts<T, V>(u, x[j], lane, vi, g.nv, g.h + vi * V, n, vi < g.nv, gh,
                 left[j], right[j]);
  }
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int64_t vi = (warp * kVecs + j) * 32 + lane;
    if (vi >= g.nv) continue;
    T lx[V], out[V];
    lap_vec<T, V>(x[j], left[j], right[j], lx);
#pragma unroll
    for (int c = 0; c < V; ++c)
      out[c] = Dc * lx[c] + k * x[j][c] * (T(1) - x[j][c]);
    store_vec<T, V>(f + g.h + vi * V, out);
  }

  if (blockIdx.x == 0 && threadIdx.x < 2) {  // head (thread 0), tail (1)
    const int64_t tail = g.h + g.nv * V;
    for (int64_t i = threadIdx.x == 0 ? 0 : tail;
         i < (threadIdx.x == 0 ? g.h : n); ++i) {
      const T ui = u[i];
      f[i] = Dc * lap_at(u, i, n, gh) + k * ui * (T(1) - ui);
    }
  }
}

// Block sum of (a, b) in float64, in a fixed order, into thread 0's
// (ra, rb). A warp sums both with one shuffle per level: at the first level
// lanes 0-15 keep a and lanes 16-31 keep b, each sending the other value to
// its partner, so lanes 0-15 end with the warp's sum of a and lanes 16-31
// with its sum of b, each with the same bits. The warps' sums meet in
// shared memory after one barrier and warp 0 adds them the same way. Shared
// memory is free for reuse only after the caller's next barrier.
__device__ __forceinline__ void block_sum2(double a, double b, double* sh,
                                           double& ra, double& rb) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const bool hi = lane >= 16;
  double s = hi ? b : a;
  s += __shfl_xor_sync(kFull, hi ? a : b, 16);
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  if ((lane & 15) == 0) sh[(hi ? kWarps : 0) + w] = s;
  __syncthreads();
  if (w == 0) {
    const int i = lane & 15;
    s = i < kWarps ? sh[(hi ? kWarps : 0) + i] : 0.0;
#pragma unroll
    for (int o = kWarps / 2; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
    ra = s;
    rb = __shfl_sync(kFull, s, 16);
  }
}

// K2's slots: one 64-bit word per (block, sum), holding a float64's bits,
// or kEmptySlot, a NaN whose payload arithmetic never produces (the card's
// NaN results are canonical), while the block has not written it.
constexpr unsigned long long kEmptySlot = 0x7ff4d2c15ea5e000ull;
constexpr unsigned long long kCanonicalNaN = 0x7fffffffffffffffull;
// A wait longer than this is a fault (a slot no block writes): trap, do
// not hang.
constexpr unsigned long long kSlotTimeoutNs = 10000000000ull;

__device__ __forceinline__ unsigned long long slot_bits(double x) {
  const unsigned long long b =
      static_cast<unsigned long long>(__double_as_longlong(x));
  return b == kEmptySlot ? kCanonicalNaN : b;
}

// A slot's store and poll: relaxed gpu-scope atomics.
__device__ __forceinline__ void slot_store(unsigned long long* slot,
                                           unsigned long long bits) {
  asm volatile("st.relaxed.gpu.b64 [%0], %1;" ::"l"(slot), "l"(bits));
}

__device__ __forceinline__ unsigned long long slot_load(
    const unsigned long long* slot) {
  unsigned long long bits;
  asm volatile("ld.relaxed.gpu.b64 %0, [%1];" : "=l"(bits) : "l"(slot));
  return bits;
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    rd1d_bwd_kernel(const T* __restrict__ u, const T* __restrict__ p,
                    const T* __restrict__ lam, T inv_dx2, T* __restrict__ du,
                    unsigned long long* __restrict__ slots,
                    T* __restrict__ dp, int64_t n,
                    const T* __restrict__ gh) {
  __shared__ double sh[2 * kWarps];
  // the shard's ghosts of u and of lam, or null for the edge copy
  const T* gu = gh;
  const T* gl = gh ? gh + 2 : nullptr;
  const T Dc = p[0] * inv_dx2;
  const T k = p[1];
  const Layout<T, V> g(u, n);
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;

  T x[kVecs][V], l[kVecs][V];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int64_t vi = (warp * kVecs + j) * 32 + lane;
    if (vi < g.nv) {
      load_vec<T, V>(u + g.h + vi * V, x[j]);
      load_vec<T, V>(lam + g.h + vi * V, l[j]);
    } else {
#pragma unroll
      for (int c = 0; c < V; ++c) x[j][c] = l[j][c] = T(0);
    }
  }
  T xl[kVecs], xr[kVecs], ll[kVecs], lr[kVecs];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int64_t vi = (warp * kVecs + j) * 32 + lane;
    const int64_t i0 = g.h + vi * V;
    ghosts<T, V>(u, x[j], lane, vi, g.nv, i0, n, vi < g.nv, gu, xl[j],
                 xr[j]);
    ghosts<T, V>(lam, l[j], lane, vi, g.nv, i0, n, vi < g.nv, gl, ll[j],
                 lr[j]);
  }
  T sD = T(0), sk = T(0);
  T out[kVecs][V];  // stored after the block's partial, below
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int64_t vi = (warp * kVecs + j) * 32 + lane;
    if (vi >= g.nv) continue;
    T lu[V], llam[V];
    lap_vec<T, V>(x[j], xl[j], xr[j], lu);
    lap_vec<T, V>(l[j], ll[j], lr[j], llam);
#pragma unroll
    for (int c = 0; c < V; ++c) {
      const T ui = x[j][c];
      const T li = l[j][c];
      out[j][c] = Dc * llam[c] + k * (T(1) - T(2) * ui) * li;
      sD += li * lu[c];
      sk += li * ui * (T(1) - ui);
    }
  }

  if (blockIdx.x == 0 && threadIdx.x < 2) {  // head (thread 0), tail (1)
    const int64_t tail = g.h + g.nv * V;
    for (int64_t i = threadIdx.x == 0 ? 0 : tail;
         i < (threadIdx.x == 0 ? g.h : n); ++i) {
      const T ui = u[i];
      const T li = lam[i];
      du[i] = Dc * lap_at(lam, i, n, gl) + k * (T(1) - T(2) * ui) * li;
      sD += li * lap_at(u, i, n, gu);
      sk += li * ui * (T(1) - ui);
    }
  }

  double bD, bk;
  block_sum2(sD, sk, sh, bD, bk);
  if (threadIdx.x == 0) {
    slot_store(slots + 2 * blockIdx.x, slot_bits(bD));
    slot_store(slots + 2 * blockIdx.x + 1, slot_bits(bk));
  }
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int64_t vi = (warp * kVecs + j) * 32 + lane;
    if (vi < g.nv) store_vec<T, V>(du + g.h + vi * V, out[j]);
  }
  if (blockIdx.x != gridDim.x - 1) return;

  // the last block: every partial, in block-index order (thread t sums
  // t, t + kThreads, ...), kLoads slots in flight per thread, each polled
  // until it holds a value and then emptied for the next launch
  constexpr int kLoads = 4;
  const unsigned long long start = now_ns();
  double pD = 0.0, pk = 0.0;
  for (unsigned b0 = threadIdx.x; b0 < gridDim.x; b0 += kLoads * kThreads) {
    unsigned long long q[kLoads][2];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const unsigned b = b0 + i * kThreads;
      if (b < gridDim.x) {
        q[i][0] = slot_load(slots + 2 * b);
        q[i][1] = slot_load(slots + 2 * b + 1);
      }
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const unsigned b = b0 + i * kThreads;
      if (b >= gridDim.x) continue;
      for (int c = 0; c < 2; ++c) {
        while (q[i][c] == kEmptySlot) {
          if (now_ns() - start > kSlotTimeoutNs) __trap();
          q[i][c] = slot_load(slots + 2 * b + c);
        }
      }
      pD += __longlong_as_double(static_cast<long long>(q[i][0]));
      pk += __longlong_as_double(static_cast<long long>(q[i][1]));
      slot_store(slots + 2 * b, kEmptySlot);
      slot_store(slots + 2 * b + 1, kEmptySlot);
    }
  }
  __syncthreads();  // warp 0 has read sh in the first block sum
  block_sum2(pD, pk, sh, bD, bk);
  if (threadIdx.x == 0) {
    dp[0] = static_cast<T>(static_cast<double>(inv_dx2) * bD);
    dp[1] = static_cast<T>(bk);
  }
}

int64_t blocks_for(int64_t n, int vec_cells) {
  const int64_t per_block = static_cast<int64_t>(kThreads) * kVecs * vec_cells;
  const int64_t b = (n + per_block - 1) / per_block;
  return b > 0 ? b : 1;
}

bool same_mod16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) ^ reinterpret_cast<uintptr_t>(b)) &
          15u) == 0;
}

template <typename T>
int launch_fwd(const void* u, const void* p, double inv_dx2, void* f,
               int64_t n, const void* ghosts, void* stream) {
  if (n <= 0) return 0;
  constexpr int V = 16 / sizeof(T);
  if (!same_mod16(u, f)) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* uu = static_cast<const T*>(u);
  const T* pp = static_cast<const T*>(p);
  rd1d_fwd_kernel<T, V>
      <<<static_cast<unsigned>(blocks_for(n, V)), kThreads, 0, s>>>(
          uu, pp, static_cast<T>(inv_dx2), static_cast<T*>(f), n,
          static_cast<const T*>(ghosts));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* u, const void* p, const void* lam, double inv_dx2,
               void* du, void* slots, void* dp, int64_t n, int vec,
               const void* ghosts, void* stream) {
  if (n <= 0) return 0;
  constexpr int V = 16 / sizeof(T);
  if (!same_mod16(u, du) || (vec && !same_mod16(u, lam)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* uu = static_cast<const T*>(u);
  const T* pp = static_cast<const T*>(p);
  const T* ll = static_cast<const T*>(lam);
  T* dd = static_cast<T*>(du);
  unsigned long long* sl = static_cast<unsigned long long*>(slots);
  T* dpp = static_cast<T*>(dp);
  const T* gh = static_cast<const T*>(ghosts);
  if (vec) {
    rd1d_bwd_kernel<T, V>
        <<<static_cast<unsigned>(blocks_for(n, V)), kThreads, 0, s>>>(
            uu, pp, ll, static_cast<T>(inv_dx2), dd, sl, dpp, n, gh);
  } else {
    rd1d_bwd_kernel<T, 1>
        <<<static_cast<unsigned>(blocks_for(n, 1)), kThreads, 0, s>>>(
            uu, pp, ll, static_cast<T>(inv_dx2), dd, sl, dpp, n, gh);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The value every slot of K2's workspace holds before a launch and after.
int64_t rd1d_bwd_empty_slot() { return static_cast<int64_t>(kEmptySlot); }

// Blocks of a K2 launch over n cells of elt_bytes each, on 16-byte vectors
// (vec != 0) or single cells: the (dD, dk) slot pairs its workspace
// holds.
int64_t rd1d_bwd_blocks(int64_t n, int elt_bytes, int vec) {
  return blocks_for(n, vec ? 16 / elt_bytes : 1);
}

// ghosts: null (the edge copy) or a shard's ghost cells on the device,
// [left, right] of u (K1), then of lam (K2).
int rd1d_fwd_f32(const void* u, const void* p, double inv_dx2, void* f,
                 int64_t n, const void* ghosts, void* stream) {
  return launch_fwd<float>(u, p, inv_dx2, f, n, ghosts, stream);
}

int rd1d_fwd_f64(const void* u, const void* p, double inv_dx2, void* f,
                 int64_t n, const void* ghosts, void* stream) {
  return launch_fwd<double>(u, p, inv_dx2, f, n, ghosts, stream);
}

int rd1d_bwd_f32(const void* u, const void* p, const void* lam,
                 double inv_dx2, void* du, void* slots, void* dp, int64_t n,
                 int vec, const void* ghosts, void* stream) {
  return launch_bwd<float>(u, p, lam, inv_dx2, du, slots, dp, n, vec,
                           ghosts, stream);
}

int rd1d_bwd_f64(const void* u, const void* p, const void* lam,
                 double inv_dx2, void* du, void* slots, void* dp, int64_t n,
                 int vec, const void* ghosts, void* stream) {
  return launch_bwd<double>(u, p, lam, inv_dx2, du, slots, dp, n, vec,
                            ghosts, stream);
}

}  // extern "C"
