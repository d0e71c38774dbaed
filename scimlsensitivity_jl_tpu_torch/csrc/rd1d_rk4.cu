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
// window offset i*C - start.
//
// A shard of a state split over ranks. u is then one rank's n cells, and a
// device buffer `ghosts` holds the H cells beyond each of its ends, the
// neighbours' edge cells: [left H | right H] of u (then of lam, for K6),
// left ghost j < 0 at ghosts[H + j], right ghost j >= n at ghosts[H + j - n].
// gl and gr are the ghost cells a side has (H at an inner shard end, 0 at a
// global end, where the edge copy applies as before), and the clamp becomes
// clamp(i*C - H, -gl, n + gr - W): it stops at the global ends only, so a
// tile at an inner shard end reads its window across the cut from the
// buffer. The caller makes W = min(C + 2H, gl + n + gr), H = 4(S+1) for
// every tile count. A null buffer with gl = gr = 0 reads u alone, the
// unsharded kernel's bits: the launch then takes the kernels' kGhosted =
// false instances, whose loads are the plain u[j] of a whole grid.
//
// Register tile. Thread t of a block owns the R consecutive window cells
// [t*R, t*R + R) and keeps every stage value of its cells in registers; the
// block has ceil(W / R) threads rounded up to whole warps, and the cells past
// W (the last thread's padding) compute values that no window cell reads. A
// stencil needs, per thread, only its left neighbour's last cell and its right
// neighbour's first: inside a warp they come by __shfl_up_sync /
// __shfl_down_sync, across warps through a shared array of each warp's two
// edge values (double-buffered, so one __syncthreads() per exchange). Thread
// 0's left neighbour is its own first cell (the window's left ghost); the
// window's last cell W - 1 takes its own value as its right neighbour, by a
// select on the cell index (K5 runs a second copy of each stage, without
// the select, on the warps that do not hold that cell). No window-wide array
// lives in shared memory except K6's entry-state cache.
//
// K5 rd1d_rk4_fwd_kernel replaces the Pallas kernel
//    scimlsensitivity_jl_tpu/ops/pallas_pde.py:_rk4_fwd_kernel_factory (via
//    make_rd1d_rk4_block -> _block_fwd). The window is read once from device
//    memory and the interior written once; all 4*S stages run in registers
//    (state, stage input, k1, k2 + k3), 4 exchanges per step. Bound by
//    operations on this card: 44 flops per cell per step against 8 bytes per
//    float32 cell per launch (u read, u written), so at S = 16 about
//    16*44/8 = 88 flops per byte, above the H100's 67e12 / 3.35e12 = 20.
//    R = 8 (16 for windows above 4608 float32 or 4096 float64 cells): the
//    per-stage exchange (two shuffles, two shared-memory edge values per
//    warp, one barrier) is paid once per 8 cells, and the flagship window of
//    4232 cells makes 17 warps per block, two blocks per SM.
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
//    This kernel keeps only the S step-entry states in shared memory, laid
//    out [step][r][thread] so that a warp's accesses fall on 32 banks: it
//    re-steps the window once from u to fill them (S - 1 register steps),
//    and the reverse sweep recomputes the stage states u2, u3, u4 of step s
//    from its entry state when it reaches s. Each thread writes and reads
//    back only its own cells, so the cache needs no barrier. lam, the entry
//    state, u2, u3, the current w and the running s4 + s3 + s2 stay in
//    registers: 7 exchanges per reverse step in 6 barriers (lam goes with
//    u3). At a tile of 1024 and S = 16 (W = 1160, R = 4, 320 threads) the
//    cache is 80 KB in float32 and 160 KB in float64. Bound by operations:
//    the function's own work is 44 flops per cell per step for the stage
//    states and 74 for the reverse sweep, against 12 bytes per float32 cell
//    (u, lam read, du written); the recomputation (S - 1 re-steps plus 3
//    field evaluations per reverse step) is the design's, paid in arithmetic
//    to stay on chip. dD and dk are summed per thread over the interior
//    cells, then per block in a fixed tree, and a second one-block pass sums
//    the per-block partials in a fixed order: no atomics, the same bits
//    every run.
//
// Both kernels read D and k from the device vector p, take h and inv_dx2 as
// arguments, launch on the caller's stream, never synchronise, allocate
// nothing, and the launchers return cudaGetLastError() (or
// cudaErrorInvalidValue for a window larger than the register tile or, for
// K6, than the card's shared memory, which the Python wrapper checks first).
// K6's opt-in to more than 48 KB of shared memory, and the card's limit, are
// set and read once per process per instantiation and device.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kReduceThreads = 1024;  // threads of the one-block reduction
constexpr int kMaxDevices = 64;

// K5's tiles: R = 8 cells per thread while the window fits kMax8 threads,
// else R = 16 up to kMax16. K6's: R = 4 up to kMaxThreads. The most threads
// of a block, times the blocks that should share an SM, set the register
// budget (65536 / (threads x blocks) per thread): K5 keeps about 5R live
// values per thread, K6 about 7R. Two float32 K5 blocks of R = 8 share an SM,
// which the flagship window (4232 cells, 544 threads) needs to fill it.
template <typename T>
struct FwdTiles {
  static constexpr int kMax8 = sizeof(T) == 4 ? 576 : 512;
  static constexpr int kBlocks8 = sizeof(T) == 4 ? 2 : 1;
  static constexpr int kMax16 = sizeof(T) == 4 ? 640 : 384;
};

template <typename T>
struct BwdTile {
  static constexpr int R = 4;
  static constexpr int kMaxThreads = sizeof(T) == 4 ? 640 : 512;
};

constexpr int kMaxWarps = 32;  // 1024 threads
constexpr int kParity = 4 * (kMaxWarps + 1);  // stride of the edge buffers

// Bytes of a K6 block's static shared memory (edge values and the per-warp
// sums) are at most this; the rest of the card's limit is its dynamic cache.
constexpr int64_t kBwdStaticSmem = 4096;

// The two edge values of a thread's neighbours: the last cell of the thread
// to the left, the first cell of the thread to the right.
template <typename T>
struct Nb {
  T l, r;
};

// The block's neighbour exchange through a shared buffer of [2 parities]
// [kMaxWarps + 1][4] values: slots 0 and 1 of a warp hold its first and last
// cell of one array, 2 and 3 of a second, and the last 4 take the stores of
// the lanes that post nothing. Lane 0 posts its first cell and reads the
// left warp's last (warp 0 its own first, the window's left ghost); lane 31
// posts its last cell and reads the right warp's first (the last warp its
// own last, which no window cell reads). Every lane stores and loads once
// per array, so the exchange has no branch. Two exchanges in a row use the
// two buffers (parities) in turn, so that no warp overwrites values another
// still reads; the parity is fixed at each call site, since an RK4 step
// makes 4 exchanges and K6's reverse step 6.
template <typename T>
struct Exchange {
  T* buf;
  int put, get;  // this lane's slots
  bool first_lane, last_lane;
};

template <typename T>
__device__ __forceinline__ Exchange<T> exchange_of(T* buf) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int left = warp > 0 ? 4 * (warp - 1) + 1 : 0;
  const int right = warp + 1 < nwarps ? 4 * (warp + 1) : 4 * warp + 1;
  return {buf,
          lane == 0 ? 4 * warp : (lane == 31 ? 4 * warp + 1 : 4 * kMaxWarps),
          lane == 31 ? right : left, lane == 0, lane == 31};
}

template <int P, int Slot, typename T, int R>
__device__ __forceinline__ void post(const Exchange<T>& e, const T (&x)[R]) {
  e.buf[P * kParity + 2 * Slot + e.put] = e.first_lane ? x[0] : x[R - 1];
}

template <int P, int Slot, typename T, int R>
__device__ __forceinline__ Nb<T> fetch(const Exchange<T>& e, const T (&x)[R]) {
  const T got = e.buf[P * kParity + 2 * Slot + e.get];
  const T l = __shfl_up_sync(kFull, x[R - 1], 1);
  const T r = __shfl_down_sync(kFull, x[0], 1);
  return {e.first_lane ? got : l, e.last_lane ? got : r};
}

// Every thread's neighbours of x, after one barrier, through parity P.
template <int P, typename T, int R>
__device__ __forceinline__ Nb<T> neighbours(const Exchange<T>& e,
                                            const T (&x)[R]) {
  post<P, 0>(e, x);
  __syncthreads();
  return fetch<P, 0>(e, x);
}

// ... of two arrays, after one barrier.
template <int P, typename T, int R>
__device__ __forceinline__ void neighbours2(const Exchange<T>& e,
                                            const T (&x)[R], const T (&y)[R],
                                            Nb<T>& nx, Nb<T>& ny) {
  post<P, 0>(e, x);
  post<P, 1>(e, y);
  __syncthreads();
  nx = fetch<P, 0>(e, x);
  ny = fetch<P, 1>(e, y);
}

// L(x) at the thread's cell r; hi is the index in the thread of the window's
// last cell, whose right neighbour is its own value.
template <typename T, int R>
__device__ __forceinline__ T lap_r(const T (&x)[R], Nb<T> nb, int r, int hi) {
  const T xl = r == 0 ? nb.l : x[r - 1];
  const T xr = r == hi ? x[r] : (r + 1 < R ? x[r + 1] : nb.r);
  return (xl - T(2) * x[r]) + xr;
}

template <typename T, int R>
__device__ __forceinline__ T field_r(const T (&x)[R], Nb<T> nb, int r, int hi,
                                     T Dc, T k) {
  return Dc * lap_r(x, nb, r, hi) + k * x[r] * (T(1) - x[r]);
}

// L(c * x) at cell r, with c * x formed at each of the three cells as the
// TPU kernel forms w4 = h/6 lam before its Laplacian.
template <typename T, int R>
__device__ __forceinline__ T lap_scaled_r(const T (&x)[R], Nb<T> nb, T c,
                                          int r, int hi) {
  const T xl = c * (r == 0 ? nb.l : x[r - 1]);
  const T xr = c * (r == hi ? x[r] : (r + 1 < R ? x[r + 1] : nb.r));
  return (xl - T(2) * (c * x[r])) + xr;
}

// Runs f on a thread's cells. Most warps do not hold the window's last cell:
// for them f gets std::true_type, under which it folds its per-cell test
// away (the last cell's index becomes -1); the others get std::false_type
// and test each cell. The branch is uniform in each warp and holds no
// barrier.
template <typename F>
__device__ __forceinline__ void over_cells(bool plain, F&& f) {
  if (plain) {
    f(std::true_type{});
  } else {
    f(std::false_type{});
  }
}

struct Coeffs {
  double h, hh, h6, h26;  // h, h/2, h/6, 2h/6
};

Coeffs coeffs(double h) { return {h, 0.5 * h, h / 6.0, 2.0 * h / 6.0}; }

// One RK4 step of the thread's cells u, in place, in 4 exchanges; plain:
// the warp does not hold the window's last cell, whose index among this
// thread's cells is hi.
template <typename T, int R>
__device__ __forceinline__ void rk4_step(const Exchange<T>& e, T (&u)[R],
                                         bool plain, int hi, T Dc, T k, T h,
                                         T hh, T h6) {
  T k1[R], k23[R], xa[R], xb[R];
  Nb<T> nb = neighbours<0>(e, u);
  over_cells(plain, [&](auto fold) {
    const int last = decltype(fold)::value ? -1 : hi;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      k1[r] = field_r(u, nb, r, last, Dc, k);
      xa[r] = u[r] + hh * k1[r];
    }
  });
  nb = neighbours<1>(e, xa);
  over_cells(plain, [&](auto fold) {
    const int last = decltype(fold)::value ? -1 : hi;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      k23[r] = field_r(xa, nb, r, last, Dc, k);
      xb[r] = u[r] + hh * k23[r];
    }
  });
  nb = neighbours<0>(e, xb);
  over_cells(plain, [&](auto fold) {
    const int last = decltype(fold)::value ? -1 : hi;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const T k3 = field_r(xb, nb, r, last, Dc, k);
      k23[r] = k23[r] + k3;
      xa[r] = u[r] + h * k3;
    }
  });
  nb = neighbours<1>(e, xa);
  over_cells(plain, [&](auto fold) {
    const int last = decltype(fold)::value ? -1 : hi;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const T k4 = field_r(xa, nb, r, last, Dc, k);
      u[r] = u[r] + h6 * (k1[r] + T(2) * k23[r] + k4);
    }
  });
}

// Whether the warp's cells [warp * 32R, (warp + 1) * 32R) miss cell W - 1.
template <int R>
__device__ __forceinline__ bool misses_last(int W) {
  return (W - 1) / (32 * R) != static_cast<int>(threadIdx.x >> 5);
}

__device__ __forceinline__ int64_t window_start(int64_t i, int64_t n, int C,
                                                int H, int W, int gl, int gr) {
  int64_t start = i * C - H;
  if (start > n + gr - W) start = n + gr - W;
  if (start < -gl) start = -gl;
  return start;
}

// Cell j of a shard's u (or lam), j in [-gl, n + gr): its own cells from x,
// the others from the ghost buffer g (see the header); x[j] alone where the
// launch has no ghost buffer (kGhosted false).
template <bool kGhosted, typename T>
__device__ __forceinline__ T cell(const T* __restrict__ x,
                                  const T* __restrict__ g, int64_t j,
                                  int64_t n, int H) {
  if (kGhosted) {
    if (j < 0) return g[H + j];
    if (j >= n) return g[H + (j - n)];
  }
  return x[j];
}

template <typename T, int R, int kMaxThreads, int kBlocks, bool kGhosted>
__global__ void __launch_bounds__(kMaxThreads, kBlocks)
rd1d_rk4_fwd_kernel(const T* __restrict__ u, const T* __restrict__ p,
                    T inv_dx2, T h, T hh, T h6, T* __restrict__ out,
                    int64_t n, int S, int C, int H, int W,
                    const T* __restrict__ ghosts, int gl, int gr) {
  __shared__ T edge_buf[2 * kParity];
  const int64_t i = blockIdx.x;
  const int64_t start = window_start(i, n, C, H, W, gl, gr);
  const int off = static_cast<int>(i * C - start);
  const T Dc = p[0] * inv_dx2;
  const T k = p[1];
  const int base = threadIdx.x * R;
  const int hi = W - 1 - base;
  const Exchange<T> e = exchange_of(edge_buf);
  T x[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    x[r] = cell<kGhosted>(u, ghosts, start + min(base + r, W - 1), n, H);
  }
  const bool plain = misses_last<R>(W);
  for (int s = 0; s < S; ++s) rk4_step(e, x, plain, hi, Dc, k, h, hh, h6);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int c = base + r - off;
    if (c >= 0 && c < C) out[i * C + c] = x[r];
  }
}

// Sum of v over the block in a fixed order (warp shuffles, then warp 0),
// valid in thread 0. red holds one value per warp.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
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

template <typename T, bool kGhosted>
__global__ void __launch_bounds__(BwdTile<T>::kMaxThreads)
rd1d_rk4_bwd_kernel(const T* __restrict__ u, const T* __restrict__ p,
                    const T* __restrict__ lam, T inv_dx2, T h, T hh, T h6,
                    T h26, T* __restrict__ du, T* __restrict__ partials,
                    int64_t n, int S, int C, int H, int W,
                    const T* __restrict__ ghosts, int gl, int gr) {
  constexpr int R = BwdTile<T>::R;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T edge_buf[2 * kParity];
  __shared__ T red[kMaxWarps];
  static_assert(sizeof(edge_buf) + sizeof(red) <= kBwdStaticSmem,
                "static shared memory above its reserve");
  const int64_t i = blockIdx.x;
  const int64_t start = window_start(i, n, C, H, W, gl, gr);
  const int off = static_cast<int>(i * C - start);
  const T Dc = p[0] * inv_dx2;
  const T k = p[1];
  const int nt = blockDim.x;
  // lam's ghosts follow u's in the buffer
  const T* lam_ghosts = ghosts == nullptr ? nullptr : ghosts + 2 * H;
  const int base = threadIdx.x * R;
  const int hi = W - 1 - base;
  const int lo = off - base;    // the thread's interior cells: lo <= r < hc
  const int hc = off + C - base;
  const Exchange<T> e = exchange_of(edge_buf);
  // the entry-state cache, [S][R][nt]: this thread's cell r of step s is
  // mine[(s * R + r) * nt]
  T* mine = reinterpret_cast<T*>(smem_raw) + threadIdx.x;
  T U[R];   // the entry state of the current step
  T lm[R];  // lam
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = base + r;
    U[r] = cell<kGhosted>(u, ghosts, start + min(j, W - 1), n, H);
    lm[r] = j < W ? cell<kGhosted>(lam, lam_ghosts, start + j, n, H) : T(0);
  }
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int r = 0; r < R; ++r) mine[(s * R + r) * nt] = U[r];
    // every warp tests each cell (plain = false): K5's second, test-free
    // copy for the warps away from the window's last cell made K6 slower on
    // the card, its loops being twice as long
    if (s + 1 < S) rk4_step(e, U, false, hi, Dc, k, h, hh, h6);
  }
  T tD = T(0);  // this thread's share of sum (L w_i) u_i over interior cells
  T tk = T(0);  // ... of sum w_i u_i (1 - u_i)
  for (int s = S - 1; s >= 0; --s) {
    if (s + 1 < S) {
#pragma unroll
      for (int r = 0; r < R; ++r) U[r] = mine[(s * R + r) * nt];
    }
    T u2[R], u3[R], w[R], wn[R], ss[R];
    Nb<T> nb = neighbours<0>(e, U);  // (a) u2
#pragma unroll
    for (int r = 0; r < R; ++r) {
      u2[r] = U[r] + hh * field_r(U, nb, r, hi, Dc, k);
    }
    nb = neighbours<1>(e, u2);  // (b) u3
#pragma unroll
    for (int r = 0; r < R; ++r) {
      u3[r] = U[r] + hh * field_r(u2, nb, r, hi, Dc, k);
    }
    Nb<T> nl;
    neighbours2<0>(e, u3, lm, nb, nl);  // (c) u4, s4, w3
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const T u4 = U[r] + h * field_r(u3, nb, r, hi, Dc, k);
      const T w4 = h6 * lm[r];
      const T lw4 = lap_scaled_r(lm, nl, h6, r, hi);
      const T s4 = Dc * lw4 + k * (T(1) - T(2) * u4) * w4;
      w[r] = h26 * lm[r] + h * s4;
      ss[r] = s4;
      if (r >= lo && r < hc) {
        tD += lw4 * u4;
        tk += w4 * u4 * (T(1) - u4);
      }
    }
    nb = neighbours<1>(e, w);  // (d) s3, w2
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const T lw3 = lap_r(w, nb, r, hi);
      const T s3 = Dc * lw3 + k * (T(1) - T(2) * u3[r]) * w[r];
      wn[r] = h26 * lm[r] + hh * s3;
      ss[r] = ss[r] + s3;
      if (r >= lo && r < hc) {
        tD += lw3 * u3[r];
        tk += w[r] * u3[r] * (T(1) - u3[r]);
      }
    }
    nb = neighbours<0>(e, wn);  // (e) s2, w1
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const T lw2 = lap_r(wn, nb, r, hi);
      const T s2 = Dc * lw2 + k * (T(1) - T(2) * u2[r]) * wn[r];
      w[r] = h6 * lm[r] + hh * s2;
      ss[r] = ss[r] + s2;
      if (r >= lo && r < hc) {
        tD += lw2 * u2[r];
        tk += wn[r] * u2[r] * (T(1) - u2[r]);
      }
    }
    nb = neighbours<1>(e, w);  // (f) s1, lam
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const T lw1 = lap_r(w, nb, r, hi);
      const T s1 = Dc * lw1 + k * (T(1) - T(2) * U[r]) * w[r];
      lm[r] = (lm[r] + s1) + ss[r];  // lam's neighbours are read only in (c)
      if (r >= lo && r < hc) {
        tD += lw1 * U[r];
        tk += w[r] * U[r] * (T(1) - U[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int c = base + r - off;
    if (c >= 0 && c < C) du[i * C + c] = lm[r];
  }
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

// A launch's tile: cells per thread, threads per block (whole warps), bytes
// of dynamic shared memory, and the most threads the kernel takes.
struct Tile {
  int R, threads;
  int64_t smem;
  int max_threads;
};

int warps_for(int W, int R) { return ((W + R - 1) / R + 31) / 32; }

template <typename T>
Tile fwd_tile(int W) {
  using F = FwdTiles<T>;
  const int threads8 = 32 * warps_for(W, 8);
  if (threads8 <= F::kMax8) return {8, threads8, 0, F::kMax8};
  return {16, 32 * warps_for(W, 16), 0, F::kMax16};
}

template <typename T>
Tile bwd_tile(int W, int S) {
  using B = BwdTile<T>;
  const int threads = 32 * warps_for(W, B::R);
  const int64_t smem = static_cast<int64_t>(S) * B::R * threads * sizeof(T);
  return {B::R, threads, smem, B::kMaxThreads};
}

// The dynamic shared memory a K6 block of device dev may take: the opt-in
// limit per block less kBwdStaticSmem, read once per device (0 if it cannot
// be read).
int64_t smem_limit(int dev) {
  static int64_t known[kMaxDevices] = {};
  if (dev < 0 || dev >= kMaxDevices) return 0;
  if (known[dev] == 0) {
    int limit = 0;
    if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess) {
      return 0;
    }
    known[dev] = limit - kBwdStaticSmem;
  }
  return known[dev];
}

int64_t num_tiles(int64_t n, int C) { return (n + C - 1) / C; }

template <typename T>
int launch_fwd(const void* u, const void* p, double inv_dx2, double h,
               void* out, int64_t n, int S, int C, int H, int W,
               const void* ghosts, int gl, int gr, void* stream) {
  if (n <= 0) return 0;
  const Tile t = fwd_tile<T>(W);
  if (t.threads > t.max_threads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Coeffs c = coeffs(h);
  using F = FwdTiles<T>;
  auto kernel =
      ghosts == nullptr
          ? (t.R == 8 ? rd1d_rk4_fwd_kernel<T, 8, F::kMax8, F::kBlocks8, false>
                      : rd1d_rk4_fwd_kernel<T, 16, F::kMax16, 1, false>)
          : (t.R == 8 ? rd1d_rk4_fwd_kernel<T, 8, F::kMax8, F::kBlocks8, true>
                      : rd1d_rk4_fwd_kernel<T, 16, F::kMax16, 1, true>);
  kernel<<<static_cast<unsigned>(num_tiles(n, C)), t.threads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const T*>(p),
      static_cast<T>(inv_dx2), static_cast<T>(c.h), static_cast<T>(c.hh),
      static_cast<T>(c.h6), static_cast<T*>(out), n, S, C, H, W,
      static_cast<const T*>(ghosts), gl, gr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* u, const void* p, const void* lam, double inv_dx2,
               double h, void* du, void* partials, void* dp, int64_t n, int S,
               int C, int H, int W, const void* ghosts, int gl, int gr,
               void* stream) {
  if (n <= 0) return 0;
  // per instantiation, device and kernel (with a ghost buffer or without)
  static bool opted_in[2][kMaxDevices] = {};
  const bool ghosted = ghosts != nullptr;
  auto kernel = ghosted ? rd1d_rk4_bwd_kernel<T, true>
                        : rd1d_rk4_bwd_kernel<T, false>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Tile t = bwd_tile<T>(W, S);
  const int64_t limit = smem_limit(dev);
  if (t.threads > t.max_threads || t.smem > limit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!opted_in[ghosted][dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(limit));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[ghosted][dev] = true;
  }
  const Coeffs c = coeffs(h);
  const int64_t tiles = num_tiles(n, C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<static_cast<unsigned>(tiles), t.threads,
           static_cast<size_t>(t.smem), s>>>(
      static_cast<const T*>(u), static_cast<const T*>(p),
      static_cast<const T*>(lam), static_cast<T>(inv_dx2),
      static_cast<T>(c.h), static_cast<T>(c.hh), static_cast<T>(c.h6),
      static_cast<T>(c.h26), static_cast<T*>(du), static_cast<T*>(partials),
      n, S, C, H, W, static_cast<const T*>(ghosts), gl, gr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rd1d_rk4_bwd_reduce_kernel<T><<<1, kReduceThreads, 0, s>>>(
      static_cast<const T*>(partials), tiles, static_cast<T>(inv_dx2),
      static_cast<T*>(dp));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The tile of K5 (which = 0) or K6 (which = 1) for a window of W cells at S
// steps with values of elt bytes (4 or 8): cells per thread, threads per
// block, dynamic shared memory in bytes, and the most threads a block of
// that kernel takes. Returns 0, or 1 for another which or elt.
int rd1d_rk4_tile(int which, int W, int S, int elt, int* R, int* threads,
                  int64_t* smem, int* max_threads) {
  Tile t{};
  if (which == 0 && elt == 4) t = fwd_tile<float>(W);
  else if (which == 0 && elt == 8) t = fwd_tile<double>(W);
  else if (which == 1 && elt == 4) t = bwd_tile<float>(W, S);
  else if (which == 1 && elt == 8) t = bwd_tile<double>(W, S);
  else return 1;
  *R = t.R;
  *threads = t.threads;
  *smem = t.smem;
  *max_threads = t.max_threads;
  return 0;
}

// The dynamic shared memory a K6 block of device dev may take.
int64_t rd1d_rk4_smem_limit(int dev) { return smem_limit(dev); }

int rd1d_rk4_fwd_f32(const void* u, const void* p, double inv_dx2, double h,
                     void* out, int64_t n, int S, int C, int H, int W,
                     const void* ghosts, int gl, int gr, void* stream) {
  return launch_fwd<float>(u, p, inv_dx2, h, out, n, S, C, H, W, ghosts, gl,
                         gr, stream);
}

int rd1d_rk4_fwd_f64(const void* u, const void* p, double inv_dx2, double h,
                     void* out, int64_t n, int S, int C, int H, int W,
                     const void* ghosts, int gl, int gr, void* stream) {
  return launch_fwd<double>(u, p, inv_dx2, h, out, n, S, C, H, W, ghosts, gl,
                         gr, stream);
}

int rd1d_rk4_bwd_f32(const void* u, const void* p, const void* lam,
                     double inv_dx2, double h, void* du, void* partials,
                     void* dp, int64_t n, int S, int C, int H, int W,
                     const void* ghosts, int gl, int gr, void* stream) {
  return launch_bwd<float>(u, p, lam, inv_dx2, h, du, partials, dp, n, S, C,
                           H, W, ghosts, gl, gr, stream);
}

int rd1d_rk4_bwd_f64(const void* u, const void* p, const void* lam,
                     double inv_dx2, double h, void* du, void* partials,
                     void* dp, int64_t n, int S, int C, int H, int W,
                     const void* ghosts, int gl, int gr, void* stream) {
  return launch_bwd<double>(u, p, lam, inv_dx2, h, du, partials, dp, n, S, C,
                            H, W, ghosts, gl, gr, stream);
}

}  // extern "C"
