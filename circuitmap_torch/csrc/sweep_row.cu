// Strictly sequential CAVIaR spike sweep (block 1) for sm_90a.
//
// Replaces three Pallas TPU kernels of circuitmap_tpu/ops/sweep_pallas.py
// that compute one function, the per-row algebra _sweep_body (:181-230):
// sweep_spikes_pallas_dma (:338, body _sweep_kernel_dma :248-334) and
// sweep_spikes_pallas (:89, body _sweep_kernel :35-82), one experiment
// each, and sweep_spikes_pallas_batched (:481, body :432-477), E
// independent experiments. One coordinate-ascent sweep visits the N
// spike-posterior rows one at a time in `order`; each row reads the
// residual r = mu @ lam as the rows before it left it and, when done,
// sets r = r_excl + new_mu * new_lam (the reference's algebra).
//
// What bounds it on this card: bytes. A sweep must read lam and stim
// ([E, N, K] f32 each) and write the new lam once: 3*E*N*K*4 bytes, 240 MB
// at E=1/N=1000/K=20000, 72 us at 3.35 TB/s. The arithmetic (~30 flops
// per element) is far below the f32 peak. But the N rows form a chain:
// row i+1 reads the r that row i wrote, so the sweep is N dependent
// steps, each a pass over K, a block-wide reduction and a second pass.
//
// What this first design does about it: one thread block per experiment
// walks the rows in order. Column k belongs to one thread for the whole
// sweep (k = tid + j * THREADS), so that thread alone reads and writes
// r[k], y[k], mask[k] and out[., k]: r lives in device memory (the
// wrapper's [E, K] buffer, initialised to mu @ lam) and needs neither a
// barrier nor shared memory, which lifts the K limit of the blocked
// kernel (r in shared memory, K <= 56,064). Per row, pass 1 computes est,
// writes it and r_excl, and accumulates the P bucket sums and the total
// in registers; warp butterflies and one shared-memory pass (double
// buffered by row parity, so one barrier per row) give every thread the
// same sums, hence the same gate; pass 2 gates the row and adds
// new_mu * new_lam to its own columns of r, and is skipped when it would
// change nothing (gate 1 and mu 0). The chain of N rows, each with a
// barrier and two dependent passes over K on one SM, is what sets the
// time, far from the byte bound; spreading a row over SMs is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;  // == 32: one partial per lane

template <int P>
__global__ void __launch_bounds__(THREADS) sweep_row_kernel(
    const float* __restrict__ y, const float* __restrict__ mask,
    const float* __restrict__ stim, const float* __restrict__ lam,
    const float* __restrict__ mu, const float* __restrict__ beta,
    const float* __restrict__ m0, const float* __restrict__ m1,
    const float* __restrict__ counts, const float* __restrict__ powers,
    const int* __restrict__ order, const float* __restrict__ scalars,
    float* __restrict__ r, float* __restrict__ out, int N, int K) {
  constexpr int NS = P + 1;  // P bucket sums + the total
  __shared__ float s_red[2][NS][WARPS];

  const int e = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t NK = (size_t)N * K;
  y += (size_t)e * K;
  mask += (size_t)e * K;
  r += (size_t)e * K;
  stim += e * NK;
  lam += e * NK;
  out += e * NK;
  mu += (size_t)e * N;
  beta += (size_t)e * N;
  m0 += (size_t)e * N;
  m1 += (size_t)e * N;
  counts += (size_t)e * N * P;
  order += (size_t)e * N;
  const float sig = scalars[4 * e + 0];
  const float msrmp = scalars[4 * e + 1];
  const float min_count = scalars[4 * e + 2];
  const float gate_active = scalars[4 * e + 3];
  float pw[P];
#pragma unroll
  for (int p = 0; p < P; ++p) pw[p] = powers[p];

  for (int i = 0; i < N; ++i) {
    const int n = order[i];
    const float mun = mu[n], bn = beta[n], m0n = m0[n], m1n = m1[n];
    const float* lam_n = lam + (size_t)n * K;
    const float* stim_n = stim + (size_t)n * K;
    float* out_n = out + (size_t)n * K;

    // pass 1: est for row n, its bucket sums, and r_excl in place of r
    float acc[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) acc[s] = 0.f;
#pragma unroll 4
    for (int k = tid; k < K; k += THREADS) {
      const float st = stim_n[k];
      const float r_excl = r[k] - mun * lam_n[k];
      const float quad =
          sig * (-2.f * y[k] * mun + 2.f * mun * r_excl + (mun * mun + bn * bn));
      const float x = m0n * st - m1n - 0.5f * quad;
      const float est = st > 0.f ? mask[k] * (1.f / (1.f + expf(-x))) : 0.f;
      r[k] = r_excl;
      out_n[k] = est;
#pragma unroll
      for (int p = 0; p < P; ++p)
        if (st == pw[p]) acc[p] += est;
      acc[P] += est;
    }

    // block reduction: every lane of every warp ends with the same sums
    const int buf = i & 1;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      float v = acc[s];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) s_red[buf][s][warp] = v;
    }
    __syncthreads();
    float sum[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      float v = s_red[buf][s][lane];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      sum[s] = v;
    }

    // the gate, from the isotonic fit at max power (suffix-mean maximum)
    float rates[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float c = counts[(size_t)n * P + p];
      rates[p] = sum[p] / (c + 1e-4f * (c == 0.f ? 1.f : 0.f));
    }
    float iso = rates[P - 1], run = rates[P - 1], cnt = 1.f;
#pragma unroll
    for (int p = P - 2; p >= 0; --p) {
      run += rates[p];
      cnt += 1.f;
      iso = fmaxf(iso, run / cnt);
    }
    const bool ok = iso >= msrmp && sum[P] >= min_count;
    const float gate = gate_active > 0.f ? (ok ? 1.f : 0.f) : 1.f;
    const float new_mu = mun * gate;

    // pass 2: the gated row, and r = r_excl + new_mu * new_lam
    if (gate != 1.f || new_mu != 0.f) {
#pragma unroll 4
      for (int k = tid; k < K; k += THREADS) {
        const float nl = out_n[k] * gate;
        out_n[k] = nl;
        r[k] = r[k] + new_mu * nl;
      }
    }
  }
}

template <int P>
cudaError_t launch(const float* y, const float* mask, const float* stim,
                   const float* lam, const float* mu, const float* beta,
                   const float* m0, const float* m1, const float* counts,
                   const float* powers, const int* order,
                   const float* scalars, float* r, float* out, int E, int N,
                   int K, cudaStream_t stream) {
  sweep_row_kernel<P><<<E, THREADS, 0, stream>>>(
      y, mask, stim, lam, mu, beta, m0, m1, counts, powers, order, scalars, r,
      out, N, K);
  return cudaGetLastError();
}

}  // namespace

// Pointers: y, mask, r [E, K]; stim, lam, out [E, N, K]; mu, beta, m0, m1
// [E, N]; counts [E, N, P]; powers [P]; order [E, N] int32 row orders
// (permutations); scalars [E, 4] = (sig, msrmp_eff, min_count,
// gate_active). r holds mu @ lam on entry and is overwritten. All float32
// unless stated, contiguous, on the device. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int cm_sweep_row_f32(
    const void* y, const void* mask, const void* stim, const void* lam,
    const void* mu, const void* beta, const void* m0, const void* m1,
    const void* counts, const void* powers, const void* order,
    const void* scalars, void* r, void* out, int E, int N, int K, int P,
    void* stream) {
#define CM_ROW_CASE(PP)                                                      \
  case PP:                                                                   \
    return (int)launch<PP>(                                                  \
        (const float*)y, (const float*)mask, (const float*)stim,             \
        (const float*)lam, (const float*)mu, (const float*)beta,             \
        (const float*)m0, (const float*)m1, (const float*)counts,            \
        (const float*)powers, (const int*)order, (const float*)scalars,      \
        (float*)r, (float*)out, E, N, K, (cudaStream_t)stream);
  switch (P) {
    CM_ROW_CASE(1)
    CM_ROW_CASE(2)
    CM_ROW_CASE(3)
    CM_ROW_CASE(4)
    CM_ROW_CASE(5)
    CM_ROW_CASE(6)
    CM_ROW_CASE(7)
    CM_ROW_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef CM_ROW_CASE
}
