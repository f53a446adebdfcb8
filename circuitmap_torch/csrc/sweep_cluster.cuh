// CAVIaR spike sweep on one thread-block cluster per experiment, sm_90a.
//
// Replaces four Pallas TPU kernels of circuitmap_tpu/ops/sweep_pallas.py
// that share the per-row algebra _sweep_body (:181-230):
//   B > 1 rows a step: sweep_spikes_pallas_dma_blocked (:658) and its
//     batched form sweep_spikes_pallas_dma_blocked_batched (:850, body
//     _make_blocked_kernel_batched :712-846): blocks of B consecutive rows
//     visited in `border` order, Jacobi within a block (every row reads
//     the residual r = mu @ lam as it stood at the block's start),
//     Gauss-Seidel across blocks, a rank-B update of r per block. B is a
//     runtime count of 2 rows or more (the JAX package's pinned
//     sweep_block_size, 8 by default). A block of more than MAX_ROWS rows
//     runs as `subs` sub-steps of at most one warp's rows, all against
//     the residual of the block's start; their updates of r gather in a
//     scratch row `dacc` and reach r once, after the block's last
//     sub-step;
//   one row a step (SEQ): sweep_spikes_pallas_dma (:338, body :248-334),
//     sweep_spikes_pallas (:89, body :35-82) and
//     sweep_spikes_pallas_batched (:481, body :432-477): single rows in
//     `order`, each updating r = r_excl + new_mu * new_lam (the
//     reference's algebra).
// P, the number of power levels (1..MAX_P), is a template parameter, as
// are the schedules of one row and of the default 8 rows a step. P = 0
// is the path for any count above MAX_P (`a.P` at run time): there the
// per-row, per-level sums cannot sit in registers or in one CTA's shared
// memory (32 rows x 1025 sums from each of 16 CTAs), so est is written
// first and then read back once per chunk of PC levels, each chunk's
// sums reduced in the CTA into global scratch; the CTAs exchange their
// partials through global scratch across a cluster barrier, and every
// CTA sums them in rank order as the fixed-P path does. A simple layout
// that is right: speed at many levels is later work.
//
// What bounds it on this card: bytes. A sweep must read stim and lam
// ([E, N, K] f32 each) and write the new lam once: 3*E*N*K*4 bytes, 240 MB
// at E=1/N=1000/K=20000, 72 us at 3.35 TB/s; the arithmetic (~30 flops an
// element) is far below the f32 peak. But the steps (ceil(N/B) of them)
// form a chain through r: each step is a pass over K, a reduction over K
// of B x (P+1) sums (the per-power spike counts and the total, from which
// each row's gate follows) and a second pass that needs those gates.
//
// What the cluster design does about it. One cluster of C CTAs (16 where
// the card admits it, else 8) runs one experiment; CTA `rank` owns the
// columns [rank*cols, rank*cols + cols) for the whole sweep, and thread
// `tid` owns the column quads tid, tid + THREADS, ... of that slice. So C
// SMs stream the bytes instead of one, and every array indexed by column
// (r, y, mask, est, the rows in flight) is touched by one thread only and
// needs no barrier. Per step:
//   1. pass 1: est of the step's rows on the thread's columns and the
//      B x (P+1) partial sums, G rows at a time (G rows' sums fit in
//      registers: 8 up to 8 levels, 4 above); warp butterflies and one
//      shared pass reduce them in the CTA;
//   2. each CTA writes its partials into slot [rank] of every CTA's
//      exchange buffer through distributed shared memory (st.async), and
//      each store completes its bytes on the receiving CTA's mbarrier;
//   3. in every CTA, thread j waits on that mbarrier, then sums row j's
//      partials over the C ranks in rank order: identical partials in an
//      identical order give bit-identical sums, hence the same gate in
//      every CTA (a gate that differed between slices would corrupt r).
//      The slots and mbarriers alternate by step parity: a CTA sends step
//      t+2's partials only after it has received every CTA's step t+1
//      partials, which each CTA sends after reading its step t slot, so
//      no cluster-wide barrier (with its device-wide fence) is needed
//      inside the sweep;
//   4. pass 2 gates the rows, writes them out and updates the thread's own
//      columns of r, G rows at a time.
// Where the plan (ops/sweep_cuda.py::cluster_plan) finds room, r, y, mask
// and est stay in shared memory, so stim and lam are read once and the
// output written once (the 3*E*N*K*4 bytes of the bound), and a ring of
// `depth` steps of stim and lam rows is prefetched with cp.async while the
// barriers wait (the rows do not depend on r: the visiting order is known
// ahead). Each thread copies and later reads only its own quads, so the
// ring needs no barrier either. Where the slice is too wide, r stays in
// the wrapper's [E, K] buffer and est in `out` (read back from L2), and
// the rows come straight from device memory.
//
// The kernel's instantiations are spread over several sources (one range
// of P each, sweep_cluster*.cu) so that nvcc builds them in parallel; this
// header holds the kernel, and CM_SWEEP_DEFINE_RANGE the per-range entry.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cm_sweep {

constexpr int THREADS = 512;  // ops/sweep_cuda.py::CLUSTER_THREADS
constexpr int WARPS = THREADS / 32;
constexpr int MAX_ROWS = 32;  // ops/sweep_cuda.py::MAX_BLOCK: one warp
constexpr int MAX_P = 16;     // ops/sweep_cuda.py::MAX_POWERS
constexpr int GATES = 32;     // s_gate floats: MAX_ROWS
constexpr int DYN_G = 4;      // P = 0: rows a thread holds at once
constexpr int DYN_PC = 8;     // P = 0: levels a pass (ops/sweep_cuda.py)
static_assert(MAX_ROWS <= 32, "a step's rows are one warp's lanes");

// T: float, or double for the float64 fits (parity-oracle fits: only the
// runtime-level form P = 0 is instantiated in double, sweep_cluster_f64.cu)
template <typename T>
struct ArgsT {
  const T *y, *mask, *stim, *lam, *mu, *beta, *m0, *m1, *counts, *powers;
  const int* steps;       // [E, nsteps]: block indices (rows > 1) or rows
  const T* scalars;       // [E, 4]: sig, msrmp_eff, min_count, gate_active
  T* r;                   // [E, K]: mu @ lam on entry, scratch after
  T* out;                 // [E, N, K]
  T* dacc;                // [E, K] zeros: a block's update of r (subs > 1)
  T* xg;                  // P = 0: [E, 3, cluster, rows * (P + 1)] scratch
  // rows: a sub-step's rows (1..MAX_ROWS); block: a block's rows; subs:
  // sub-steps a block (1 unless block > MAX_ROWS); P: the level count
  int N, K, nsteps, rows, cols, depth, block, subs, P;
};
using Args = ArgsT<float>;
using Args64 = ArgsT<double>;

// the launch and occupancy entries of one range of P (CM_SWEEP_DEFINE_RANGE)
using LaunchFn = int (*)(int P, const Args& a, int E, int cluster,
                         int on_chip, int smem, cudaStream_t stream);
using ActiveFn = int (*)(int P, int rows, int cluster, int on_chip,
                         int smem);

namespace detail {
namespace {

namespace cg = cooperative_groups;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// a column quad (16 bytes in float, 32 in double: two copies)
template <typename T>
__device__ __forceinline__ void cp_async_quad(T* dst, const T* src) {
  cp_async16(dst, src);
  if constexpr (sizeof(T) == 8) cp_async16(dst + 2, src + 2);
}

// one element, or zero bytes when !valid (src is then not read)
__device__ __forceinline__ void cp_async_elem(float* dst, const float* src,
                                              bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_elem(double* dst, const double* src,
                                              bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

// the scalar functions of the sweep in T
__device__ __forceinline__ float t_exp(float x) { return expf(x); }
__device__ __forceinline__ double t_exp(double x) { return exp(x); }
__device__ __forceinline__ float t_max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double t_max(double a, double b) {
  return fmax(a, b);
}
template <typename T>
__device__ __forceinline__ T t_nan() {
  if constexpr (sizeof(T) == 4)
    return __int_as_float(0x7fc00000);
  else
    return __longlong_as_double(0x7ff8000000000000LL);
}
// the rate's guard against an empty bucket, as the plain version spells it
template <typename T>
__device__ __forceinline__ T t_tiny() {
  if constexpr (sizeof(T) == 4)
    return 1e-4f;
  else
    return 1e-4;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` of this thread's copy groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// one arrival, and `bytes` more to come through complete_tx
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// v into CTA `rank`'s shared memory at the address `addr` has in this
// CTA, completing sizeof(v) bytes on that CTA's mbarrier at `bar`'s address
template <typename T>
__device__ __forceinline__ void st_remote(unsigned addr, unsigned bar,
                                          unsigned rank, T v) {
  unsigned raddr, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(raddr)
               : "r"(addr), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rbar)
               : "r"(bar), "r"(rank));
  if constexpr (sizeof(T) == 4) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
        "[%2];\n" ::"r"(raddr),
        "r"(__float_as_uint(v)), "r"(rbar)
        : "memory");
  } else {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, "
        "[%2];\n" ::"r"(raddr),
        "l"(__double_as_longlong(v)), "r"(rbar)
        : "memory");
  }
}

// Columns c..c+3 of a row at p (local column index), of which the first
// nv exist: one 16-byte access (two in double) where vec (16-byte
// aligned) and all four exist, else one per column, reading 0 past the
// end. Arrays on chip are zero-padded to whole quads and are accessed
// with nv = 4, vec = true.
template <typename T>
__device__ __forceinline__ void load4(T v[4], const T* p, int c, int nv,
                                      bool vec) {
  if (vec && nv == 4) {
    if constexpr (sizeof(T) == 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + c);
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    } else {
      const double2 a = *reinterpret_cast<const double2*>(p + c);
      const double2 b = *reinterpret_cast<const double2*>(p + c + 2);
      v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = i < nv ? p[c + i] : T(0);
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* p, int c, const T v[4], int nv,
                                       bool vec) {
  if (vec && nv == 4) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(p + c) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      *reinterpret_cast<double2*>(p + c) = make_double2(v[0], v[1]);
      *reinterpret_cast<double2*>(p + c + 2) = make_double2(v[2], v[3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < nv) p[c + i] = v[i];
  }
}

// R: the rows a step when fixed at compile time (1, the strictly
// sequential schedule; 8, the default block), or 0 for a runtime count
// a.rows (2..MAX_ROWS a sub-step, a.subs sub-steps a block). The fixed 8
// keeps the default's loops unrolled and its offsets constant: taken at
// run time, 8 rows ran ~15% slower in the profiled main-path fit
// (PERF.md). P: the level count, or 0 for a.P (above MAX_P). T: the
// element type (float; double for the float64 fits, where shared memory
// holds half the columns and the quads are 32 bytes).
template <int P, int R, bool ON_CHIP, typename T = float>
__global__ void __launch_bounds__(THREADS, 1)
    sweep_cluster_kernel(const ArgsT<T> a) {
  constexpr bool SEQ = R == 1;
  constexpr bool DYN = P == 0;
  constexpr int PT = DYN ? 1 : P;  // register arrays' level count
  // rows whose sums and parameters a thread holds in registers at once
  constexpr int G = SEQ ? 1 : (DYN ? DYN_G : (P <= 8 ? 8 : 4));
  constexpr int NPAR = DYN ? 4 : 4 + P;  // per row: mu, beta, m0, m1, counts
  const int B = R > 0 ? R : a.rows;      // a (sub-)step's rows
  const int S = R > 0 ? 1 : a.subs;      // sub-steps a block
  const int NP = DYN ? a.P : P;
  const int NS = B * (NP + 1);  // per row: P bucket sums + the total
  const int RS = DYN ? DYN_G * DYN_PC : NS;  // a warp's row of `red`
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  T* smem = reinterpret_cast<T*>(smem_bytes);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int e = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = a.N, K = a.K, cols = a.cols, depth = a.depth;
  const int k0 = rank * cols;
  const int width = max(0, min(K, k0 + cols) - k0);  // this CTA's columns
  const int quads = (width + 3) / 4;

  // shared memory, in the order cluster_plan counts it (elements of T;
  // each part a multiple of 4, so every part starts 16-byte aligned)
  T* xbuf = smem;                          // [2][C][NS] exchanged partials
  T* red = xbuf + (DYN ? 0 : 2 * C * NS);  // [WARPS][RS]
  T* s_gate = red + WARPS * RS;            // [B], GATES elements
  T* s_par = s_gate + GATES;               // [2][B][NPAR]
  const int par_floats = (2 * B * NPAR + 3) & ~3;
  // s_n0: [2] first rows and [2] row counts, ints in 4 elements' room;
  // then xbar: [2] mbarriers (4 elements)
  int* s_n0 = reinterpret_cast<int*>(s_par + par_floats);
  unsigned long long* xbar =
      reinterpret_cast<unsigned long long*>(s_par + par_floats + 4);
  T* rest = s_par + par_floats + 8;

  const size_t NK = (size_t)N * K;
  const T* stim = a.stim + e * NK + k0;
  const T* lam = a.lam + e * NK + k0;
  T* out = a.out + e * NK + k0;
  const T* counts = a.counts + (size_t)e * N * NP;
  const int* steps = a.steps + (size_t)e * a.nsteps;
  const T sig = a.scalars[4 * e + 0];
  const T msrmp = a.scalars[4 * e + 1];
  const T min_count = a.scalars[4 * e + 2];
  const T gate_active = a.scalars[4 * e + 3];
  const T tiny = t_tiny<T>();
  T pw[PT];
  if constexpr (!DYN) {
#pragma unroll
    for (int p = 0; p < P; ++p) pw[p] = a.powers[p];
  }
  // P = 0: the exchanged partials [2][C][NS] and this CTA's rank sums [NS]
  T* xg = DYN ? a.xg + (size_t)e * 3 * C * NS : nullptr;
  T* xsum = DYN ? xg + (size_t)(2 * C + rank) * NS : nullptr;
  T* dacc = S > 1 ? a.dacc + (size_t)e * K + k0 : nullptr;
  const int nsub = a.nsteps * S;  // sub-steps of the sweep

  // every row and every slice starts 16-byte aligned (cols % 4 == 0)
  const bool vec16 =
      K % 4 == 0 &&
      (((uintptr_t)a.y | (uintptr_t)a.mask | (uintptr_t)a.stim |
        (uintptr_t)a.lam | (uintptr_t)a.r | (uintptr_t)a.out |
        (uintptr_t)a.dacc) & 15) == 0;

  // r, y, mask by local column, on chip or in device memory; est: the
  // step's rows [B][cols] on chip, else `out` itself
  T* r;
  const T *y, *mask;
  T* est = nullptr;
  T* ring;
  {
    T* gr = a.r + (size_t)e * K + k0;
    const T* gy = a.y + (size_t)e * K + k0;
    const T* gm = a.mask + (size_t)e * K + k0;
    if constexpr (ON_CHIP) {
      T* sr = rest;
      T* sy = sr + cols;
      T* sm = sy + cols;
      est = sm + cols;
      ring = est + B * cols;
      for (int q = tid; q < cols / 4; q += THREADS) {
        const int c = 4 * q;
        const int nv = min(4, width - c);
        T v[4];
        load4(v, gr, c, nv, vec16);
        store4(sr, c, v, 4, true);
        load4(v, gy, c, nv, vec16);
        store4(sy, c, v, 4, true);
        load4(v, gm, c, nv, vec16);
        store4(sm, c, v, 4, true);
      }
      r = sr, y = sy, mask = sm;
    } else {
      r = gr, y = gy, mask = gm;
      ring = rest;
    }
  }
  const bool vec_r = ON_CHIP || vec16;   // how r, y, mask are accessed
  const int slot_floats = 2 * B * cols;  // per step: [B][stim, lam]

  // the `steps` entry of sub-step t
  auto entry = [&](int t) {
    return t < nsub ? steps[SEQ ? t : t / S] : 0;
  };
  // the first row of sub-step t, whose `steps` entry is idx, and its rows
  auto first_row = [&](int t, int idx) {
    return SEQ ? idx : idx * a.block + (t % S) * B;
  };
  auto row_count = [&](int t, int idx) {
    if (SEQ) return 1;
    const int end = min(N, (idx + 1) * a.block);
    return max(0, min(B, end - first_row(t, idx)));
  };

  // copy sub-step t's stim and lam rows of this thread's quads into the ring
  auto issue = [&](int t, int idx) {
    if (t < nsub) {
      const int n0 = first_row(t, idx);
      const int nrows = row_count(t, idx);
      T* slot = ring + (t % depth) * slot_floats;
      for (int q = tid; q < quads; q += THREADS) {
        const int c = 4 * q;
        const int nv = min(4, width - c);
        for (int j = 0; j < nrows; ++j) {
          const T* gs = stim + (size_t)(n0 + j) * K + c;
          const T* gl = lam + (size_t)(n0 + j) * K + c;
          T* ds = slot + (2 * j) * cols + c;
          T* dl = ds + cols;
          if (vec16 && nv == 4) {
            cp_async_quad(ds, gs);
            cp_async_quad(dl, gl);
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              cp_async_elem(ds + i, gs + min(i, nv - 1), i < nv);
              cp_async_elem(dl + i, gl + min(i, nv - 1), i < nv);
            }
          }
        }
      }
    }
    cp_async_commit();  // one group a step, empty past the end
  };

  // row parameters of a sub-step into s_par[t & 1] (warp 0, one lane a
  // row)
  auto fetch = [&](int t, int idx, T* v) {
    const int n = first_row(t, idx) + lane;
    const bool ok = lane < row_count(t, idx);
    v[0] = ok ? a.mu[(size_t)e * N + n] : T(0);
    v[1] = ok ? a.beta[(size_t)e * N + n] : T(0);
    v[2] = ok ? a.m0[(size_t)e * N + n] : T(0);
    v[3] = ok ? a.m1[(size_t)e * N + n] : T(0);
#pragma unroll
    for (int p = 0; p < NPAR - 4; ++p)
      v[4 + p] = ok ? counts[(size_t)n * NP + p] : T(0);
  };
  auto publish = [&](int t, int idx, const T* v) {
    if (lane < B) {
      T* d = s_par + ((t & 1) * B + lane) * NPAR;
#pragma unroll
      for (int i = 0; i < NPAR; ++i) d[i] = v[i];
    }
    if (lane == 0) {
      s_n0[t & 1] = first_row(t, idx);
      s_n0[2 + (t & 1)] = row_count(t, idx);
    }
  };

  // P = 0: the per-level sums of rows g0..g0+G-1 of the sub-step at n0
  // into part, DYN_PC levels a pass over the thread's columns, reading
  // back the est that pass 1 wrote (each thread its own columns)
  auto level_sums = [&](int g0, T* part, int n0, int nrows, const T* slot,
                        bool ringed) {
    for (int c0 = 0; c0 < NP; c0 += DYN_PC) {
      T lv[DYN_PC], acc[G * DYN_PC];
#pragma unroll
      for (int p = 0; p < DYN_PC; ++p)  // NaN past the last level
        lv[p] = c0 + p < NP ? a.powers[c0 + p] : t_nan<T>();
#pragma unroll
      for (int s = 0; s < G * DYN_PC; ++s) acc[s] = T(0);
      for (int q = tid; q < quads; q += THREADS) {
        const int c = 4 * q;
        const int nv = min(4, width - c);
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const int jj = g0 + j;
          if (jj < nrows) {
            T st[4], es[4];
            if (ringed)
              load4(st, slot + (2 * jj) * cols, c, 4, true);
            else
              load4(st, stim + (size_t)(n0 + jj) * K, c, nv, vec16);
            if constexpr (ON_CHIP)
              load4(es, est + jj * cols, c, 4, true);
            else
              load4(es, out + (size_t)(n0 + jj) * K, c, nv, vec16);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int p = 0; p < DYN_PC; ++p)
                if (st[i] == lv[p]) acc[j * DYN_PC + p] += es[i];
          }
        }
      }
#pragma unroll
      for (int s = 0; s < G * DYN_PC; ++s) {
        T v = acc[s];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0) red[warp * RS + s] = v;
      }
      __syncthreads();
      for (int i = tid; i < G * DYN_PC; i += THREADS) {
        const int j = g0 + i / DYN_PC, p = c0 + i % DYN_PC;
        if (j < B && p < NP) {
          T v = T(0);
          for (int w = 0; w < WARPS; ++w) v += red[w * RS + i];
          part[j * (NP + 1) + p] = v;
        }
      }
      __syncthreads();
    }
  };

  if (depth > 0)
    for (int t = 0; t < depth; ++t) issue(t, entry(t));
  int idx_next = entry(1);  // sub-step t+1's, one step ahead
  if (warp == 0) {
    T v[NPAR];
    const int idx0 = entry(0);
    fetch(0, idx0, v);
    publish(0, idx0, v);
  }
  if (tid == 0) {
    mbar_init(smem_u32(&xbar[0]), 1);
    mbar_init(smem_u32(&xbar[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every CTA of the cluster has started (its shared memory and its
  // mbarriers can be written) and step 0's parameters are visible
  cluster.sync();

  for (int t = 0; t < nsub; ++t) {
    const int par = t & 1;
    const unsigned bar = smem_u32(&xbar[par]);
    if (!DYN && tid == 0) mbar_expect_tx(bar, C * NS * (int)sizeof(T));
    const int n0 = s_n0[par];
    const int nrows = s_n0[2 + par];
    const T* spar = s_par + par * B * NPAR;  // this step's rows
    // the parameters of G rows (from g0 on) into registers; the first
    // group's load before the waits below, as a step of one group (1 or
    // 8 rows) needs no other
    T mu_j[G], beta_j[G], m0_j[G], m1_j[G];
    auto load_group = [&](int g0) {
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const T* v = spar + min(g0 + j, B - 1) * NPAR;
        mu_j[j] = v[0], beta_j[j] = v[1], m0_j[j] = v[2], m1_j[j] = v[3];
      }
    };
    load_group(0);
    // visiting-order entries needed later in this step, loaded now so
    // that no address waits on a load from device memory
    const int idx_after = entry(t + 2);
    const int idx_ring = depth > 0 ? entry(t + depth) : 0;
    // the next step's parameters load while this step computes
    const bool fetching = warp == 0 && t + 1 < nsub;
    T nxt[NPAR];
    if (fetching) fetch(t + 1, idx_next, nxt);

    const bool ringed = depth > 0;
    const T* slot = ring + (t % (ringed ? depth : 1)) * slot_floats;
    if (depth > 0) cp_async_wait(depth - 1);  // step t's rows have landed

    // pass 1: est of the step's rows and their bucket sums, G rows at a
    // time (every group of the step's B rows, so that each row's sums,
    // zero past the last row, reach `red`; at P = 0 the loop below sums
    // only the total, and the levels follow in chunks)
    for (int g0 = 0; g0 < B; g0 += G) {
      if (g0 > 0) load_group(g0);
      T acc[G * (P + 1)];
#pragma unroll
      for (int s = 0; s < G * (P + 1); ++s) acc[s] = T(0);
      for (int q = tid; q < quads; q += THREADS) {
        const int c = 4 * q;
        const int nv = min(4, width - c);
        const int nvr = ON_CHIP ? 4 : nv;
        T rq[4], yq[4], mq[4];
        load4(rq, r, c, nvr, vec_r);
        load4(yq, y, c, nvr, vec_r);
        load4(mq, mask, c, nvr, vec_r);
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const int jj = g0 + j;
          if (jj < nrows) {
            T st[4], lm[4], es[4];
            if (ringed) {
              load4(st, slot + (2 * jj) * cols, c, 4, true);
              load4(lm, slot + (2 * jj + 1) * cols, c, 4, true);
            } else {
              load4(st, stim + (size_t)(n0 + jj) * K, c, nv, vec16);
              load4(lm, lam + (size_t)(n0 + jj) * K, c, nv, vec16);
            }
            const T muj = mu_j[j];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const T r_excl = rq[i] - muj * lm[i];
              const T quad =
                  sig * (T(-2) * yq[i] * muj + T(2) * muj * r_excl +
                         (muj * muj + beta_j[j] * beta_j[j]));
              const T x = m0_j[j] * st[i] - m1_j[j] - T(0.5) * quad;
              const T sg = T(1) / (T(1) + t_exp(-x));
              es[i] = st[i] > T(0) ? mq[i] * sg : T(0);
#pragma unroll
              for (int p = 0; p < P; ++p)
                if (st[i] == pw[p]) acc[j * (P + 1) + p] += es[i];
              acc[j * (P + 1) + P] += es[i];
              if (SEQ) rq[i] = r_excl;
            }
            if constexpr (ON_CHIP)
              store4(est + jj * cols, c, es, 4, true);
            else
              store4(out + (size_t)(n0 + jj) * K, c, es, nv, vec16);
          }
        }
        if (SEQ) store4(r, c, rq, nvr, vec_r);  // r_excl
      }

      // the CTA's partial sums of the group's rows
      if constexpr (DYN) {
        // the totals, then the levels chunk by chunk, into this CTA's slot
        T* part = xg + (size_t)(par * C + rank) * NS;
#pragma unroll
        for (int j = 0; j < G; ++j) {
          T v = acc[j];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, o);
          if (lane == 0) red[warp * RS + j] = v;
        }
        __syncthreads();
        if (tid < G && g0 + tid < B) {
          T v = T(0);
          for (int w = 0; w < WARPS; ++w) v += red[w * RS + tid];
          part[(g0 + tid) * (NP + 1) + NP] = v;
        }
        __syncthreads();
        level_sums(g0, part, n0, nrows, slot, ringed);
      } else {
#pragma unroll
        for (int s = 0; s < G * (P + 1); ++s) {
          T v = acc[s];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, o);
          if (lane == 0 && g0 + s / (P + 1) < B)
            red[warp * NS + g0 * (P + 1) + s] = v;
        }
      }
    }
    if (fetching) publish(t + 1, idx_next, nxt);
    idx_next = idx_after;
    __syncthreads();
    if constexpr (DYN) {
      // every CTA's partials of this step are in xg; this CTA's rank sums
      __threadfence();
      cluster.sync();
      for (int i = tid; i < NS; i += THREADS) {
        T v = T(0);
        for (int q = 0; q < C; ++q)
          v += __ldcg(xg + (size_t)(par * C + q) * NS + i);
        xsum[i] = v;
      }
      __syncthreads();
    } else {
      // ... into slot [rank] of every CTA's exchange buffer
      for (int i = tid; i < NS * C; i += THREADS) {
        const int s = i % NS, dst = i / NS;
        T v = T(0);
#pragma unroll
        for (int w = 0; w < WARPS; ++w) v += red[w * NS + s];
        st_remote(smem_u32(xbuf + (par * C + rank) * NS + s), bar, dst, v);
      }
    }

    // the gates: thread j sums row j over the ranks in rank order, the
    // same sums in every CTA
    if (DYN && tid < B) {
      // the rank sums of row j are in xsum; its counts in device memory
      const int j = tid;
      const T* sj = xsum + j * (NP + 1);
      bool ok = false;
      if (j < nrows) {
        const T* cnt = counts + (size_t)(n0 + j) * NP;
        auto rate = [&](int p) {
          const T c = cnt[p];
          return sj[p] / (c + tiny * (c == T(0) ? T(1) : T(0)));
        };
        // isotonic fit at max power = max over suffix means
        T run = rate(NP - 1), iso = run, n = T(1);
        for (int p = NP - 2; p >= 0; --p) {
          run += rate(p);
          n += T(1);
          iso = t_max(iso, run / n);
        }
        ok = iso >= msrmp && sj[NP] >= min_count;
      }
      s_gate[j] = gate_active > T(0) ? (ok ? T(1) : T(0)) : T(1);
    } else if (!DYN && tid < B) {
      mbar_wait(bar, (t >> 1) & 1);  // all C partials of this step are in
      const int j = tid;
      T sum[PT + 1];
#pragma unroll
      for (int p = 0; p <= P; ++p) sum[p] = T(0);
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        if (q < C) {
          const T* src = xbuf + (par * C + q) * NS + j * (P + 1);
#pragma unroll
          for (int p = 0; p <= P; ++p) sum[p] += src[p];
        }
      }
      const T* cnt = spar + j * NPAR + 4;
      T rates[PT];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const T c = cnt[p];
        rates[p] = sum[p] / (c + tiny * (c == T(0) ? T(1) : T(0)));
      }
      // isotonic fit at max power = max over suffix means
      T iso = rates[PT - 1], run = rates[PT - 1], n = T(1);
#pragma unroll
      for (int p = P - 2; p >= 0; --p) {
        run += rates[p];
        n += T(1);
        iso = t_max(iso, run / n);
      }
      const bool ok = iso >= msrmp && sum[P] >= min_count;
      s_gate[j] = gate_active > T(0) ? (ok ? T(1) : T(0)) : T(1);
    }
    __syncthreads();

    // pass 2: the gated rows out, and this thread's columns of r, G rows
    // at a time (over all B, as pass 1: a fixed B leaves one group)
    for (int g0 = 0; g0 < B; g0 += G) {
      if (B > G) load_group(g0);  // else pass 1's one group is still in
      T gate[G];
#pragma unroll
      for (int j = 0; j < G; ++j) gate[j] = s_gate[min(g0 + j, B - 1)];
      for (int q = tid; q < quads; q += THREADS) {
        const int c = 4 * q;
        const int nv = min(4, width - c);
        const int nvr = ON_CHIP ? 4 : nv;
        T rq[4], dr[4] = {T(0), T(0), T(0), T(0)};
        if (S == 1) load4(rq, r, c, nvr, vec_r);
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const int jj = g0 + j;
          if (jj < nrows) {
            T nl[4], lm[4];
            T* orow = out + (size_t)(n0 + jj) * K;
            if constexpr (ON_CHIP)
              load4(nl, est + jj * cols, c, 4, true);
            else
              load4(nl, orow, c, nv, vec16);
#pragma unroll
            for (int i = 0; i < 4; ++i) nl[i] *= gate[j];
            store4(orow, c, nl, nv, vec16);
            if (SEQ) {
              // r = r_excl + new_mu * new_lam
#pragma unroll
              for (int i = 0; i < 4; ++i)
                rq[i] = rq[i] + (mu_j[0] * gate[0]) * nl[i];
            } else {
              if (ringed)
                load4(lm, slot + (2 * jj + 1) * cols, c, 4, true);
              else
                load4(lm, lam + (size_t)(n0 + jj) * K, c, nv, vec16);
#pragma unroll
              for (int i = 0; i < 4; ++i)
                dr[i] += (mu_j[j] * gate[j]) * nl[i] - mu_j[j] * lm[i];
            }
          }
        }
        if (S > 1) {
          // a sub-step of a long block: r waits for the block's end
          T dq[4];
          load4(dq, dacc, c, nv, vec16);
#pragma unroll
          for (int i = 0; i < 4; ++i) dq[i] += dr[i];
          store4(dacc, c, dq, nv, vec16);
        } else {
          if (!SEQ) {
#pragma unroll
            for (int i = 0; i < 4; ++i) rq[i] += dr[i];
          }
          store4(r, c, rq, nvr, vec_r);
        }
      }
    }
    if (S > 1 && t % S == S - 1) {
      // the block's last sub-step: its update reaches r, dacc is cleared
      for (int q = tid; q < quads; q += THREADS) {
        const int c = 4 * q;
        const int nv = min(4, width - c);
        const int nvr = ON_CHIP ? 4 : nv;
        T rq[4], dq[4];
        load4(rq, r, c, nvr, vec_r);
        load4(dq, dacc, c, nv, vec16);
#pragma unroll
        for (int i = 0; i < 4; ++i) rq[i] += dq[i], dq[i] = T(0);
        store4(r, c, rq, nvr, vec_r);
        store4(dacc, c, dq, nv, vec16);
      }
    }
    if (depth > 0) issue(t + depth, idx_ring);  // done with the slot
  }
  cluster.sync();  // no CTA leaves while another may still write to it
}

inline void configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                      int E, int cluster, int smem, cudaStream_t stream) {
  cfg = {};
  cfg.gridDim = dim3(cluster, E, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

template <int P, int R, bool ON_CHIP, typename T>
cudaError_t set_attributes(int cluster, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      sweep_cluster_kernel<P, R, ON_CHIP, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(sweep_cluster_kernel<P, R, ON_CHIP, T>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  return err;
}

template <int P, int R, bool ON_CHIP, typename T>
int launch(const ArgsT<T>& args, int E, int cluster, int smem,
           cudaStream_t stream) {
  cudaError_t err = set_attributes<P, R, ON_CHIP, T>(cluster, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  configure(cfg, attr, E, cluster, smem, stream);
  err = cudaLaunchKernelEx(&cfg, sweep_cluster_kernel<P, R, ON_CHIP, T>,
                           args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int P, int R, bool ON_CHIP, typename T>
int active_clusters(int cluster, int smem) {
  cudaError_t err = set_attributes<P, R, ON_CHIP, T>(cluster, smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  configure(cfg, attr, 1, cluster, smem, 0);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(
      &n, sweep_cluster_kernel<P, R, ON_CHIP, T>, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

template <int P, int R, typename T = float>
int launch_r(const ArgsT<T>& a, int E, int cluster, int on_chip, int smem,
             cudaStream_t s) {
  return on_chip ? launch<P, R, true, T>(a, E, cluster, smem, s)
                 : launch<P, R, false, T>(a, E, cluster, smem, s);
}

template <int P>
int launch_p(const Args& a, int E, int cluster, int on_chip, int smem,
             cudaStream_t s) {
  switch (a.rows) {
    case 1: return launch_r<P, 1>(a, E, cluster, on_chip, smem, s);
    case 8: return launch_r<P, 8>(a, E, cluster, on_chip, smem, s);
    default: return launch_r<P, 0>(a, E, cluster, on_chip, smem, s);
  }
}

template <int P, int R, typename T = float>
int active_r(int cluster, int on_chip, int smem) {
  return on_chip ? active_clusters<P, R, true, T>(cluster, smem)
                 : active_clusters<P, R, false, T>(cluster, smem);
}

// double: the runtime-level form (P = 0) at one row a step or a runtime
// row count (2..MAX_ROWS a sub-step), the only double instances
inline int launch_f64(const Args64& a, int E, int cluster, int on_chip,
                      int smem, cudaStream_t s) {
  return a.rows == 1
             ? launch_r<0, 1, double>(a, E, cluster, on_chip, smem, s)
             : launch_r<0, 0, double>(a, E, cluster, on_chip, smem, s);
}

inline int active_f64(int rows, int cluster, int on_chip, int smem) {
  return rows == 1 ? active_r<0, 1, double>(cluster, on_chip, smem)
                   : active_r<0, 0, double>(cluster, on_chip, smem);
}

template <int P>
int active_p(int rows, int cluster, int on_chip, int smem) {
  switch (rows) {
    case 1: return active_r<P, 1>(cluster, on_chip, smem);
    case 8: return active_r<P, 8>(cluster, on_chip, smem);
    default: return active_r<P, 0>(cluster, on_chip, smem);
  }
}

}  // namespace
}  // namespace detail

// The entries of the range of P whose first value is FIRST (4 values:
// FIRST .. FIRST + 3), one per source file.
int launch_from_1(int, const Args&, int, int, int, int, cudaStream_t);
int launch_from_5(int, const Args&, int, int, int, int, cudaStream_t);
int launch_from_9(int, const Args&, int, int, int, int, cudaStream_t);
int launch_from_13(int, const Args&, int, int, int, int, cudaStream_t);
int active_from_1(int, int, int, int, int);
int active_from_5(int, int, int, int, int);
int active_from_9(int, int, int, int, int);
int active_from_13(int, int, int, int, int);
// P = 0, the runtime level count above MAX_P (sweep_cluster_pdyn.cu)
int launch_dyn(const Args&, int, int, int, int, cudaStream_t);
int active_dyn(int, int, int, int);

}  // namespace cm_sweep

#define CM_SWEEP_DEFINE_RANGE(FIRST)                                        \
  namespace cm_sweep {                                                      \
  int launch_from_##FIRST(int P, const Args& a, int E, int cluster,         \
                          int on_chip, int smem, cudaStream_t s) {          \
    switch (P - FIRST) {                                                    \
      case 0: return detail::launch_p<FIRST>(a, E, cluster, on_chip, smem, s); \
      case 1:                                                               \
        return detail::launch_p<FIRST + 1>(a, E, cluster, on_chip, smem, s); \
      case 2:                                                               \
        return detail::launch_p<FIRST + 2>(a, E, cluster, on_chip, smem, s); \
      case 3:                                                               \
        return detail::launch_p<FIRST + 3>(a, E, cluster, on_chip, smem, s); \
    }                                                                       \
    return (int)cudaErrorInvalidValue;                                      \
  }                                                                         \
  int active_from_##FIRST(int P, int rows, int cluster, int on_chip,        \
                          int smem) {                                       \
    switch (P - FIRST) {                                                    \
      case 0: return detail::active_p<FIRST>(rows, cluster, on_chip, smem); \
      case 1:                                                               \
        return detail::active_p<FIRST + 1>(rows, cluster, on_chip, smem);   \
      case 2:                                                               \
        return detail::active_p<FIRST + 2>(rows, cluster, on_chip, smem);   \
      case 3:                                                               \
        return detail::active_p<FIRST + 3>(rows, cluster, on_chip, smem);   \
    }                                                                       \
    return -(int)cudaErrorInvalidValue;                                     \
  }                                                                         \
  }
