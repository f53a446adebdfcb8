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
//     runtime count, 2..MAX_ROWS (the JAX package's pinned
//     sweep_block_size, 8 by default);
//   one row a step (SEQ): sweep_spikes_pallas_dma (:338, body :248-334),
//     sweep_spikes_pallas (:89, body :35-82) and
//     sweep_spikes_pallas_batched (:481, body :432-477): single rows in
//     `order`, each updating r = r_excl + new_mu * new_lam (the
//     reference's algebra).
// P, the number of power levels (1..MAX_P), is a template parameter, as
// are the schedules of one row and of the default 8 rows a step.
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

namespace cm_sweep {

constexpr int THREADS = 512;  // ops/sweep_cuda.py::CLUSTER_THREADS
constexpr int WARPS = THREADS / 32;
constexpr int MAX_ROWS = 32;  // ops/sweep_cuda.py::MAX_BLOCK: one warp
constexpr int MAX_P = 16;     // ops/sweep_cuda.py::MAX_POWERS
constexpr int GATES = 32;     // s_gate floats: MAX_ROWS
static_assert(MAX_ROWS <= 32, "a step's rows are one warp's lanes");

struct Args {
  const float *y, *mask, *stim, *lam, *mu, *beta, *m0, *m1, *counts, *powers;
  const int* steps;       // [E, nsteps]: block indices (rows > 1) or rows
  const float* scalars;   // [E, 4]: sig, msrmp_eff, min_count, gate_active
  float* r;               // [E, K]: mu @ lam on entry, scratch after
  float* out;             // [E, N, K]
  int N, K, nsteps, rows, cols, depth;
};

// the launch and occupancy entries of one range of P (CM_SWEEP_DEFINE_RANGE)
using LaunchFn = int (*)(int P, const Args& a, int E, int cluster,
                         int on_chip, int smem, cudaStream_t stream);
using ActiveFn = int (*)(int P, int rows, int cluster, int on_chip,
                         int smem);

namespace detail {
namespace {

namespace cg = cooperative_groups;

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// 4 bytes, or 4 zero bytes when !valid (src is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
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
// CTA, completing 4 bytes on that CTA's mbarrier at `bar`'s address
__device__ __forceinline__ void st_remote(unsigned addr, unsigned bar,
                                          unsigned rank, float v) {
  unsigned raddr, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(raddr)
               : "r"(addr), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rbar)
               : "r"(bar), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(raddr),
      "r"(__float_as_uint(v)), "r"(rbar)
      : "memory");
}

// Columns c..c+3 of a row at p (local column index), of which the first
// nv exist: one 16-byte access where vec (16-byte aligned) and all four
// exist, else one per column, reading 0 past the end. Arrays on chip are
// zero-padded to whole quads and are accessed with nv = 4, vec = true.
__device__ __forceinline__ void load4(float v[4], const float* p, int c,
                                      int nv, bool vec) {
  if (vec && nv == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + c);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = i < nv ? p[c + i] : 0.f;
  }
}

__device__ __forceinline__ void store4(float* p, int c, const float v[4],
                                       int nv, bool vec) {
  if (vec && nv == 4) {
    *reinterpret_cast<float4*>(p + c) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < nv) p[c + i] = v[i];
  }
}

// R: the rows a step when fixed at compile time (1, the strictly
// sequential schedule; 8, the default block), or 0 for a runtime count
// a.rows (2..MAX_ROWS). The fixed 8 keeps the default's loops unrolled
// and its offsets constant: taken at run time, 8 rows ran ~15% slower in
// the profiled main-path fit (PERF.md).
template <int P, int R, bool ON_CHIP>
__global__ void __launch_bounds__(THREADS, 1)
    sweep_cluster_kernel(const Args a) {
  constexpr bool SEQ = R == 1;
  // rows whose sums and parameters a thread holds in registers at once
  constexpr int G = SEQ ? 1 : (P <= 8 ? 8 : 4);
  constexpr int NPAR = 4 + P;  // per row: mu, beta, m0, m1, counts
  const int B = R > 0 ? R : a.rows;
  const int NS = B * (P + 1);  // per row: P bucket sums + the total
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int e = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = a.N, K = a.K, cols = a.cols, depth = a.depth;
  const int k0 = rank * cols;
  const int width = max(0, min(K, k0 + cols) - k0);  // this CTA's columns
  const int quads = (width + 3) / 4;

  // shared memory, in the order cluster_plan counts it (floats; each part
  // a multiple of 4, so every part starts 16-byte aligned)
  float* xbuf = smem;                      // [2][C][NS] exchanged partials
  float* red = xbuf + 2 * C * NS;          // [WARPS][NS]
  float* s_gate = red + WARPS * NS;        // [B], GATES floats
  float* s_par = s_gate + GATES;           // [2][B][NPAR]
  const int par_floats = (2 * B * NPAR + 3) & ~3;
  // s_n0: [2] ints in 4 floats' room; then xbar: [2] mbarriers (4 floats)
  int* s_n0 = reinterpret_cast<int*>(s_par + par_floats);
  unsigned long long* xbar =
      reinterpret_cast<unsigned long long*>(s_par + par_floats + 4);
  float* rest = s_par + par_floats + 8;

  const size_t NK = (size_t)N * K;
  const float* stim = a.stim + e * NK + k0;
  const float* lam = a.lam + e * NK + k0;
  float* out = a.out + e * NK + k0;
  const float* counts = a.counts + (size_t)e * N * P;
  const int* steps = a.steps + (size_t)e * a.nsteps;
  const float sig = a.scalars[4 * e + 0];
  const float msrmp = a.scalars[4 * e + 1];
  const float min_count = a.scalars[4 * e + 2];
  const float gate_active = a.scalars[4 * e + 3];
  float pw[P];
#pragma unroll
  for (int p = 0; p < P; ++p) pw[p] = a.powers[p];

  // every row and every slice starts 16-byte aligned (cols % 4 == 0)
  const bool vec16 =
      K % 4 == 0 &&
      (((uintptr_t)a.y | (uintptr_t)a.mask | (uintptr_t)a.stim |
        (uintptr_t)a.lam | (uintptr_t)a.r | (uintptr_t)a.out) & 15) == 0;

  // r, y, mask by local column, on chip or in device memory; est: the
  // step's rows [B][cols] on chip, else `out` itself
  float* r;
  const float *y, *mask;
  float* est = nullptr;
  float* ring;
  {
    float* gr = a.r + (size_t)e * K + k0;
    const float* gy = a.y + (size_t)e * K + k0;
    const float* gm = a.mask + (size_t)e * K + k0;
    if constexpr (ON_CHIP) {
      float* sr = rest;
      float* sy = sr + cols;
      float* sm = sy + cols;
      est = sm + cols;
      ring = est + B * cols;
      for (int q = tid; q < cols / 4; q += THREADS) {
        const int c = 4 * q;
        const int nv = min(4, width - c);
        float v[4];
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

  // the first row of the step whose `steps` entry is idx
  auto first_row = [B](int idx) { return SEQ ? idx : idx * B; };

  // copy step t's stim and lam rows of this thread's quads into the ring
  auto issue = [&](int t, int idx) {
    if (t < a.nsteps) {
      const int n0 = first_row(idx);
      const int nrows = min(B, N - n0);
      float* slot = ring + (t % depth) * slot_floats;
      for (int q = tid; q < quads; q += THREADS) {
        const int c = 4 * q;
        const int nv = min(4, width - c);
        for (int j = 0; j < nrows; ++j) {
          const float* gs = stim + (size_t)(n0 + j) * K + c;
          const float* gl = lam + (size_t)(n0 + j) * K + c;
          float* ds = slot + (2 * j) * cols + c;
          float* dl = ds + cols;
          if (vec16 && nv == 4) {
            cp_async16(ds, gs);
            cp_async16(dl, gl);
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              cp_async4(ds + i, gs + min(i, nv - 1), i < nv);
              cp_async4(dl + i, gl + min(i, nv - 1), i < nv);
            }
          }
        }
      }
    }
    cp_async_commit();  // one group a step, empty past the end
  };

  // row parameters of a step into s_par[t & 1] (warp 0, one lane a row)
  auto fetch = [&](int idx, float* v) {
    const int n = first_row(idx) + lane;
    const bool ok = lane < B && n < N;
    v[0] = ok ? a.mu[(size_t)e * N + n] : 0.f;
    v[1] = ok ? a.beta[(size_t)e * N + n] : 0.f;
    v[2] = ok ? a.m0[(size_t)e * N + n] : 0.f;
    v[3] = ok ? a.m1[(size_t)e * N + n] : 0.f;
#pragma unroll
    for (int p = 0; p < P; ++p) v[4 + p] = ok ? counts[(size_t)n * P + p] : 0.f;
  };
  auto publish = [&](int t, int idx, const float* v) {
    if (lane < B) {
      float* d = s_par + ((t & 1) * B + lane) * NPAR;
#pragma unroll
      for (int i = 0; i < NPAR; ++i) d[i] = v[i];
    }
    if (lane == 0) s_n0[t & 1] = first_row(idx);
  };

  if (depth > 0)
    for (int t = 0; t < depth; ++t) issue(t, t < a.nsteps ? steps[t] : 0);
  int idx_next = a.nsteps > 1 ? steps[1] : 0;  // step t+1's, one step ahead
  if (warp == 0) {
    float v[NPAR];
    const int idx0 = steps[0];
    fetch(idx0, v);
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

  for (int t = 0; t < a.nsteps; ++t) {
    const int par = t & 1;
    const unsigned bar = smem_u32(&xbar[par]);
    if (tid == 0) mbar_expect_tx(bar, C * NS * 4);
    const int n0 = s_n0[par];
    const int nrows = min(B, N - n0);
    const float* spar = s_par + par * B * NPAR;  // this step's rows
    // the parameters of G rows (from g0 on) into registers; the first
    // group's load before the waits below, as a step of one group (1 or
    // 8 rows) needs no other
    float mu_j[G], beta_j[G], m0_j[G], m1_j[G];
    auto load_group = [&](int g0) {
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const float* v = spar + min(g0 + j, B - 1) * NPAR;
        mu_j[j] = v[0], beta_j[j] = v[1], m0_j[j] = v[2], m1_j[j] = v[3];
      }
    };
    load_group(0);
    // visiting-order entries needed later in this step, loaded now so
    // that no address waits on a load from device memory
    const int idx_after = t + 2 < a.nsteps ? steps[t + 2] : 0;
    const int idx_ring =
        depth > 0 && t + depth < a.nsteps ? steps[t + depth] : 0;
    // the next step's parameters load while this step computes
    const bool fetching = warp == 0 && t + 1 < a.nsteps;
    float nxt[NPAR];
    if (fetching) fetch(idx_next, nxt);

    const bool ringed = depth > 0;
    const float* slot = ring + (t % (ringed ? depth : 1)) * slot_floats;
    if (depth > 0) cp_async_wait(depth - 1);  // step t's rows have landed

    // pass 1: est of the step's rows and their bucket sums, G rows at a
    // time (every group of the step's B rows, so that each row's sums,
    // zero past the last row, reach `red`)
    for (int g0 = 0; g0 < B; g0 += G) {
      if (g0 > 0) load_group(g0);
      float acc[G * (P + 1)];
#pragma unroll
      for (int s = 0; s < G * (P + 1); ++s) acc[s] = 0.f;
      for (int q = tid; q < quads; q += THREADS) {
        const int c = 4 * q;
        const int nv = min(4, width - c);
        const int nvr = ON_CHIP ? 4 : nv;
        float rq[4], yq[4], mq[4];
        load4(rq, r, c, nvr, vec_r);
        load4(yq, y, c, nvr, vec_r);
        load4(mq, mask, c, nvr, vec_r);
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const int jj = g0 + j;
          if (jj < nrows) {
            float st[4], lm[4], es[4];
            if (ringed) {
              load4(st, slot + (2 * jj) * cols, c, 4, true);
              load4(lm, slot + (2 * jj + 1) * cols, c, 4, true);
            } else {
              load4(st, stim + (size_t)(n0 + jj) * K, c, nv, vec16);
              load4(lm, lam + (size_t)(n0 + jj) * K, c, nv, vec16);
            }
            const float muj = mu_j[j];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float r_excl = rq[i] - muj * lm[i];
              const float quad =
                  sig * (-2.f * yq[i] * muj + 2.f * muj * r_excl +
                         (muj * muj + beta_j[j] * beta_j[j]));
              const float x = m0_j[j] * st[i] - m1_j[j] - 0.5f * quad;
              const float sg = 1.f / (1.f + expf(-x));
              es[i] = st[i] > 0.f ? mq[i] * sg : 0.f;
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
#pragma unroll
      for (int s = 0; s < G * (P + 1); ++s) {
        float v = acc[s];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0 && g0 + s / (P + 1) < B)
          red[warp * NS + g0 * (P + 1) + s] = v;
      }
    }
    if (fetching) publish(t + 1, idx_next, nxt);
    idx_next = idx_after;
    __syncthreads();
    // ... into slot [rank] of every CTA's exchange buffer
    for (int i = tid; i < NS * C; i += THREADS) {
      const int s = i % NS, dst = i / NS;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) v += red[w * NS + s];
      st_remote(smem_u32(xbuf + (par * C + rank) * NS + s), bar, dst, v);
    }

    // the gates: thread j sums row j over the ranks in rank order, the
    // same sums in every CTA
    if (tid < B) {
      mbar_wait(bar, (t >> 1) & 1);  // all C partials of this step are in
      const int j = tid;
      float sum[P + 1];
#pragma unroll
      for (int p = 0; p <= P; ++p) sum[p] = 0.f;
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        if (q < C) {
          const float* src = xbuf + (par * C + q) * NS + j * (P + 1);
#pragma unroll
          for (int p = 0; p <= P; ++p) sum[p] += src[p];
        }
      }
      const float* cnt = spar + j * NPAR + 4;
      float rates[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float c = cnt[p];
        rates[p] = sum[p] / (c + 1e-4f * (c == 0.f ? 1.f : 0.f));
      }
      // isotonic fit at max power = max over suffix means
      float iso = rates[P - 1], run = rates[P - 1], n = 1.f;
#pragma unroll
      for (int p = P - 2; p >= 0; --p) {
        run += rates[p];
        n += 1.f;
        iso = fmaxf(iso, run / n);
      }
      const bool ok = iso >= msrmp && sum[P] >= min_count;
      s_gate[j] = gate_active > 0.f ? (ok ? 1.f : 0.f) : 1.f;
    }
    __syncthreads();

    // pass 2: the gated rows out, and this thread's columns of r, G rows
    // at a time (over all B, as pass 1: a fixed B leaves one group)
    for (int g0 = 0; g0 < B; g0 += G) {
      if (B > G) load_group(g0);  // else pass 1's one group is still in
      float gate[G];
#pragma unroll
      for (int j = 0; j < G; ++j) gate[j] = s_gate[min(g0 + j, B - 1)];
      for (int q = tid; q < quads; q += THREADS) {
        const int c = 4 * q;
        const int nv = min(4, width - c);
        const int nvr = ON_CHIP ? 4 : nv;
        float rq[4], dr[4] = {0.f, 0.f, 0.f, 0.f};
        load4(rq, r, c, nvr, vec_r);
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const int jj = g0 + j;
          if (jj < nrows) {
            float nl[4], lm[4];
            float* orow = out + (size_t)(n0 + jj) * K;
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
        if (!SEQ) {
#pragma unroll
          for (int i = 0; i < 4; ++i) rq[i] += dr[i];
        }
        store4(r, c, rq, nvr, vec_r);
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

template <int P, int R, bool ON_CHIP>
cudaError_t set_attributes(int cluster, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      sweep_cluster_kernel<P, R, ON_CHIP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(sweep_cluster_kernel<P, R, ON_CHIP>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  return err;
}

template <int P, int R, bool ON_CHIP>
int launch(const Args& args, int E, int cluster, int smem,
           cudaStream_t stream) {
  cudaError_t err = set_attributes<P, R, ON_CHIP>(cluster, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  configure(cfg, attr, E, cluster, smem, stream);
  err = cudaLaunchKernelEx(&cfg, sweep_cluster_kernel<P, R, ON_CHIP>, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int P, int R, bool ON_CHIP>
int active_clusters(int cluster, int smem) {
  cudaError_t err = set_attributes<P, R, ON_CHIP>(cluster, smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  configure(cfg, attr, 1, cluster, smem, 0);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(
      &n, sweep_cluster_kernel<P, R, ON_CHIP>, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

template <int P, int R>
int launch_r(const Args& a, int E, int cluster, int on_chip, int smem,
             cudaStream_t s) {
  return on_chip ? launch<P, R, true>(a, E, cluster, smem, s)
                 : launch<P, R, false>(a, E, cluster, smem, s);
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

template <int P, int R>
int active_r(int cluster, int on_chip, int smem) {
  return on_chip ? active_clusters<P, R, true>(cluster, smem)
                 : active_clusters<P, R, false>(cluster, smem);
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
