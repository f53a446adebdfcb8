// CAVIaR spike sweep on one thread-block cluster per experiment, sm_90a.
//
// Replaces four Pallas TPU kernels of circuitmap_tpu/ops/sweep_pallas.py
// that share the per-row algebra _sweep_body (:181-230):
//   ROWS=8: sweep_spikes_pallas_dma_blocked (:658) and its batched form
//     sweep_spikes_pallas_dma_blocked_batched (:850, body
//     _make_blocked_kernel_batched :712-846): 8-row blocks visited in
//     `border` order, Jacobi within a block (every row reads the residual
//     r = mu @ lam as it stood at the block's start), Gauss-Seidel across
//     blocks, a rank-8 update of r per block;
//   ROWS=1: sweep_spikes_pallas_dma (:338, body :248-334),
//     sweep_spikes_pallas (:89, body :35-82) and
//     sweep_spikes_pallas_batched (:481, body :432-477): single rows in
//     `order`, each updating r = r_excl + new_mu * new_lam (the
//     reference's algebra).
//
// What bounds it on this card: bytes. A sweep must read stim and lam
// ([E, N, K] f32 each) and write the new lam once: 3*E*N*K*4 bytes, 240 MB
// at E=1/N=1000/K=20000, 72 us at 3.35 TB/s; the arithmetic (~30 flops an
// element) is far below the f32 peak. But the steps (N/ROWS of them) form
// a chain through r: each step is a pass over K, a reduction over K of
// ROWS x (P+1) sums (the per-power spike counts and the total, from which
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
//      ROWS x (P+1) partial sums; warp butterflies and one shared pass
//      reduce them in the CTA;
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
//      columns of r.
// Where the plan (ops/sweep_cuda.py::cluster_plan) finds room, r, y, mask
// and est stay in shared memory, so stim and lam are read once and the
// output written once (the 3*E*N*K*4 bytes of the bound), and a ring of
// `depth` steps of stim and lam rows is prefetched with cp.async while the
// barriers wait (the rows do not depend on r: the visiting order is known
// ahead). Each thread copies and later reads only its own quads, so the
// ring needs no barrier either. Where the slice is too wide, r stays in
// the wrapper's [E, K] buffer and est in `out` (read back from L2), and
// the rows come straight from device memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;  // ops/sweep_cuda.py::CLUSTER_THREADS
constexpr int WARPS = THREADS / 32;

struct Args {
  const float *y, *mask, *stim, *lam, *mu, *beta, *m0, *m1, *counts, *powers;
  const int* steps;       // [E, nsteps]: block indices (ROWS=8) or rows
  const float* scalars;   // [E, 4]: sig, msrmp_eff, min_count, gate_active
  float* r;               // [E, K]: mu @ lam on entry, scratch after
  float* out;             // [E, N, K]
  int N, K, nsteps, cols, depth;
};

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

template <int P, int ROWS, bool ON_CHIP>
__global__ void __launch_bounds__(THREADS, 1)
    sweep_cluster_kernel(const Args a) {
  constexpr int NS = ROWS * (P + 1);  // per row: P bucket sums + the total
  constexpr int NPAR = 4 + P;         // per row: mu, beta, m0, m1, counts
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

  // shared memory, in the order cluster_plan counts it (floats)
  float* xbuf = smem;                      // [2][C][NS] exchanged partials
  float* red = xbuf + 2 * C * NS;          // [WARPS][NS]
  float* s_gate = red + WARPS * NS;        // [ROWS], padded to 8
  float* s_par = s_gate + 8;               // [2][ROWS][NPAR]
  int* s_n0 = reinterpret_cast<int*>(s_par + ((2 * ROWS * NPAR + 3) & ~3));
  // s_n0: [2] ints in 4 floats' room; then xbar: [2] mbarriers (4 floats)
  unsigned long long* xbar = reinterpret_cast<unsigned long long*>(
      s_par + ((2 * ROWS * NPAR + 3) & ~3) + 4);
  float* rest = s_par + ((2 * ROWS * NPAR + 3) & ~3) + 8;

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
  // step's rows [ROWS][cols] on chip, else `out` itself
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
      ring = est + ROWS * cols;
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
  const bool vec_r = ON_CHIP || vec16;      // how r, y, mask are accessed
  const int slot_floats = 2 * ROWS * cols;  // per step: [ROWS][stim, lam]

  // the first row of the step whose `steps` entry is idx
  auto first_row = [](int idx) { return ROWS == 1 ? idx : idx * ROWS; };

  // copy step t's stim and lam rows of this thread's quads into the ring
  auto issue = [&](int t, int idx) {
    if (t < a.nsteps) {
      const int n0 = first_row(idx);
      const int nrows = min(ROWS, N - n0);
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
    const bool ok = lane < ROWS && n < N;
    v[0] = ok ? a.mu[(size_t)e * N + n] : 0.f;
    v[1] = ok ? a.beta[(size_t)e * N + n] : 0.f;
    v[2] = ok ? a.m0[(size_t)e * N + n] : 0.f;
    v[3] = ok ? a.m1[(size_t)e * N + n] : 0.f;
#pragma unroll
    for (int p = 0; p < P; ++p) v[4 + p] = ok ? counts[(size_t)n * P + p] : 0.f;
  };
  auto publish = [&](int t, int idx, const float* v) {
    if (lane < ROWS) {
      float* d = s_par + ((t & 1) * ROWS + lane) * NPAR;
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
    const int nrows = min(ROWS, N - n0);
    float mu_j[ROWS], beta_j[ROWS], m0_j[ROWS], m1_j[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const float* v = s_par + (par * ROWS + j) * NPAR;
      mu_j[j] = v[0], beta_j[j] = v[1], m0_j[j] = v[2], m1_j[j] = v[3];
    }
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

    // pass 1: est of the step's rows, and their bucket sums
    float acc[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) acc[s] = 0.f;
    for (int q = tid; q < quads; q += THREADS) {
      const int c = 4 * q;
      const int nv = min(4, width - c);
      const int nvr = ON_CHIP ? 4 : nv;
      float rq[4], yq[4], mq[4];
      load4(rq, r, c, nvr, vec_r);
      load4(yq, y, c, nvr, vec_r);
      load4(mq, mask, c, nvr, vec_r);
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        if (j < nrows) {
          float st[4], lm[4], es[4];
          if (ringed) {
            load4(st, slot + (2 * j) * cols, c, 4, true);
            load4(lm, slot + (2 * j + 1) * cols, c, 4, true);
          } else {
            load4(st, stim + (size_t)(n0 + j) * K, c, nv, vec16);
            load4(lm, lam + (size_t)(n0 + j) * K, c, nv, vec16);
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
            if (ROWS == 1) rq[i] = r_excl;
          }
          if constexpr (ON_CHIP)
            store4(est + j * cols, c, es, 4, true);
          else
            store4(out + (size_t)(n0 + j) * K, c, es, nv, vec16);
        }
      }
      if (ROWS == 1) store4(r, c, rq, nvr, vec_r);  // r_excl
    }

    // the CTA's partial sums
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      float v = acc[s];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) red[warp * NS + s] = v;
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
    if (tid < ROWS) {
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
      const float* cnt = s_par + (par * ROWS + j) * NPAR + 4;
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
    float gate[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) gate[j] = s_gate[j];

    // pass 2: the gated rows out, and this thread's columns of r
    for (int q = tid; q < quads; q += THREADS) {
      const int c = 4 * q;
      const int nv = min(4, width - c);
      const int nvr = ON_CHIP ? 4 : nv;
      float rq[4], dr[4] = {0.f, 0.f, 0.f, 0.f};
      load4(rq, r, c, nvr, vec_r);
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        if (j < nrows) {
          float nl[4], lm[4];
          float* orow = out + (size_t)(n0 + j) * K;
          if constexpr (ON_CHIP)
            load4(nl, est + j * cols, c, 4, true);
          else
            load4(nl, orow, c, nv, vec16);
#pragma unroll
          for (int i = 0; i < 4; ++i) nl[i] *= gate[j];
          store4(orow, c, nl, nv, vec16);
          if (ROWS == 1) {
            // r = r_excl + new_mu * new_lam
#pragma unroll
            for (int i = 0; i < 4; ++i)
              rq[i] = rq[i] + (mu_j[0] * gate[0]) * nl[i];
          } else {
            if (ringed)
              load4(lm, slot + (2 * j + 1) * cols, c, 4, true);
            else
              load4(lm, lam + (size_t)(n0 + j) * K, c, nv, vec16);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              dr[i] += (mu_j[j] * gate[j]) * nl[i] - mu_j[j] * lm[i];
          }
        }
      }
      if (ROWS != 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i) rq[i] += dr[i];
      }
      store4(r, c, rq, nvr, vec_r);
    }
    if (depth > 0) issue(t + depth, idx_ring);  // done with the slot
  }
  cluster.sync();  // no CTA leaves while another may still write to it
}

void configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr, int E,
               int cluster, int smem, cudaStream_t stream) {
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

template <int P, int ROWS, bool ON_CHIP>
cudaError_t set_attributes(int cluster, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      sweep_cluster_kernel<P, ROWS, ON_CHIP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(sweep_cluster_kernel<P, ROWS, ON_CHIP>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  return err;
}

template <int P, int ROWS, bool ON_CHIP>
cudaError_t launch(const Args& args, int E, int cluster, int smem,
                   cudaStream_t stream) {
  cudaError_t err = set_attributes<P, ROWS, ON_CHIP>(cluster, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  configure(cfg, attr, E, cluster, smem, stream);
  err = cudaLaunchKernelEx(&cfg, sweep_cluster_kernel<P, ROWS, ON_CHIP>, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int P, int ROWS, bool ON_CHIP>
int active_clusters(int cluster, int smem) {
  cudaError_t err = set_attributes<P, ROWS, ON_CHIP>(cluster, smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  configure(cfg, attr, 1, cluster, smem, 0);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(
      &n, sweep_cluster_kernel<P, ROWS, ON_CHIP>, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace

#define CM_CLUSTER_CASES(CALL) \
  switch (P) {                 \
    CALL(1)                    \
    CALL(2)                    \
    CALL(3)                    \
    CALL(4)                    \
    CALL(5)                    \
    CALL(6)                    \
    CALL(7)                    \
    CALL(8)                    \
  }

// Pointers: y, mask, r [E, K]; stim, lam, out [E, N, K]; mu, beta, m0, m1
// [E, N]; counts [E, N, P]; powers [P]; steps [E, nsteps] int32 (block
// indices for rows_per_step 8, rows for 1); scalars [E, 4] = (sig,
// msrmp_eff, min_count, gate_active). r holds mu @ lam on entry and is
// overwritten. All float32 unless stated, contiguous, on the device.
// cluster, cols, on_chip, depth and smem_bytes come from the host's
// cluster_plan. Returns the cudaError_t of the launch (0 on success).
extern "C" int cm_sweep_cluster_f32(
    const void* y, const void* mask, const void* stim, const void* lam,
    const void* mu, const void* beta, const void* m0, const void* m1,
    const void* counts, const void* powers, const void* steps,
    const void* scalars, void* r, void* out, int E, int N, int K, int P,
    int nsteps, int rows_per_step, int cluster, int cols, int on_chip,
    int depth, int smem_bytes, void* stream) {
  const Args args{(const float*)y,      (const float*)mask,
                  (const float*)stim,   (const float*)lam,
                  (const float*)mu,     (const float*)beta,
                  (const float*)m0,     (const float*)m1,
                  (const float*)counts, (const float*)powers,
                  (const int*)steps,    (const float*)scalars,
                  (float*)r,            (float*)out,
                  N,                    K,
                  nsteps,               cols,
                  depth};
  if (cols % 4 != 0 || depth < 0 || depth > 4 || cluster < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define CM_LAUNCH(PP)                                                  \
  case PP:                                                             \
    return (int)(rows_per_step == 1                                    \
                     ? (on_chip ? launch<PP, 1, true>(args, E, cluster, \
                                                      smem_bytes, s)    \
                                : launch<PP, 1, false>(args, E, cluster, \
                                                       smem_bytes, s))  \
                     : (on_chip ? launch<PP, 8, true>(args, E, cluster, \
                                                      smem_bytes, s)    \
                                : launch<PP, 8, false>(args, E, cluster, \
                                                       smem_bytes, s)));
  if (rows_per_step != 1 && rows_per_step != 8)
    return (int)cudaErrorInvalidValue;
  CM_CLUSTER_CASES(CM_LAUNCH)
#undef CM_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// How many clusters of `cluster` CTAs with smem_bytes of dynamic shared
// memory (r on chip or not) the card can hold at once (0: it cannot
// launch one); a negative value is a cudaError_t.
extern "C" int cm_sweep_cluster_active(int rows_per_step, int P, int cluster,
                                       int on_chip, int smem_bytes) {
#define CM_ACTIVE(PP)                                                       \
  case PP:                                                                  \
    return rows_per_step == 1                                               \
               ? (on_chip ? active_clusters<PP, 1, true>(cluster, smem_bytes) \
                          : active_clusters<PP, 1, false>(cluster,          \
                                                          smem_bytes))      \
               : (on_chip ? active_clusters<PP, 8, true>(cluster, smem_bytes) \
                          : active_clusters<PP, 8, false>(cluster,          \
                                                          smem_bytes));
  if (rows_per_step != 1 && rows_per_step != 8)
    return -(int)cudaErrorInvalidValue;
  CM_CLUSTER_CASES(CM_ACTIVE)
#undef CM_ACTIVE
  return -(int)cudaErrorInvalidValue;
}
#undef CM_CLUSTER_CASES
