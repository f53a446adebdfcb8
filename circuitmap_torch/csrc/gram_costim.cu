// W1: the weight update's Gram matrix from the design's co-stimulation
// lists, for sm_90a.
//
// Replaces no TPU kernel: the JAX package leaves lam @ lam.T to one XLA
// dot (circuitmap_tpu/solvers/caviar.py::update_weights), and the port
// left it to cuBLAS's SGEMM: 2 N^2 K operations an iteration, 6.4 ms at
// N=2000, K=40,000.
//
// G[i, j] = sum_k lam[i, k] lam[j, k]. The spike posterior lam is zero
// wherever the stim is zero (its init, the sweeps and the reconnection
// scan all write it so), and a trial stimulates a few targets, so the
// only terms that can be nonzero are those of the trials on which i and
// j are both targets: sum_k h_k^2 of them for h_k targets on trial k,
// against the dense product's N^2 K (H = 10: 4.0e6 against 1.6e11 at
// N=2000, K=40,000).
//
// What bounds it on this card: the latency of dependent loads, and the
// pairs. The kernels write G whole (N^2 elements, zeros included, so no
// memset); the arithmetic is one fused multiply-add a pair, and each
// pair's two posteriors are read from a compact list.
//
// What this design does about it, in two launches:
// - costim_gram_gather_kernel copies each target's posterior,
//   lam[targets[t], trials[t]], into vals[t], in the trials' order: one
//   scattered read a target (K H of them) in place of one a pair.
// - costim_gram_kernel: one warp a block, one block a (row i, chunk of
//   columns); the row's chunk accumulates in shared memory and is written
//   out coalesced. At N=2000 in float a chunk is the whole row (8 KB).
//   The row walks neuron i's trials (row_trials, ascending) 32 at a
//   time. Lane q takes trial q of the batch and stages that trial's
//   targets in the chunk and their posteriors, both read contiguously
//   from targets and vals, UNROLL loads in flight; then the warp adds the
//   batch's trials into the row one after another, a trial's targets
//   over the lanes. A lane's staging slice has an odd stride, so the 32
//   lanes' staging stores fall in 32 banks.
// - Each G[i, j] starts from 0 and takes its products in ascending trial
//   order, one fused multiply-add each. The products it leaves out have a
//   zero factor. G is exactly symmetric (G[i, j] and G[j, i] take the
//   same products in the same order), and no atomics: two launches give
//   the same bits. (cuBLAS's SGEMM sums in another order: float32 G
//   differs from it by a few ulp, within both sums' rounding bound.)
// - A trial's targets are distinct, so the lanes of one trial write
//   distinct elements; __syncwarp orders one trial's writes before the
//   next one's.
// - float and double instances. Built without --use_fast_math, and the
//   multiply-add written as the intrinsic, so no flag changes it.

#include <cuda_runtime.h>

namespace cm_gram {

constexpr int LANES = 32;    // one warp a block
constexpr int UNROLL = 16;   // a lane's loads in flight
constexpr int GATHER = 256;  // threads a block of the gather

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

template <typename T>
__global__ void __launch_bounds__(GATHER)
    costim_gram_gather_kernel(const T* __restrict__ lam,
                              const int* __restrict__ targets,
                              const int* __restrict__ trials,
                              T* __restrict__ vals, int nnz, int K) {
  for (int t = blockIdx.x * GATHER + threadIdx.x; t < nnz;
       t += gridDim.x * GATHER)
    vals[t] = lam[(long long)targets[t] * K + trials[t]];
}

// grid (N, chunks): block (i, c) writes G[i, c * width : c * width + nc].
// Shared memory: the row's chunk [width], then each lane's staged
// posteriors [LANES * stride] and their columns in the chunk
// [LANES * stride].
template <typename T>
__global__ void __launch_bounds__(LANES)
    costim_gram_kernel(const T* __restrict__ vals,
                       const int* __restrict__ row_ptr,
                       const int* __restrict__ row_trials,
                       const int* __restrict__ row_pos,
                       const int* __restrict__ trial_ptr,
                       const int* __restrict__ targets, T* __restrict__ G,
                       int N, int stride, int width) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* row = reinterpret_cast<T*>(smem);
  T* stage_v = row + width;
  int* stage_j = reinterpret_cast<int*>(stage_v + LANES * stride);
  const int lane = threadIdx.x;
  const int i = blockIdx.x;
  const int c0 = blockIdx.y * width;
  const int nc = min(width, N - c0);
  for (int c = lane; c < nc; c += LANES) row[c] = T(0);
  __syncwarp();

  const int r0 = row_ptr[i], r1 = row_ptr[i + 1];
  T* my_v = stage_v + lane * stride;
  int* my_j = stage_j + lane * stride;
  for (int base = r0; base < r1; base += LANES) {
    // stage: lane q, trial base + q's posteriors in the chunk
    const int s = base + lane;
    int cnt = 0;
    T a = T(0);
    if (s < r1) {
      const int k = row_trials[s];
      a = vals[row_pos[s]];
      const int t1 = trial_ptr[k + 1];
      for (int t = trial_ptr[k]; t < t1; t += UNROLL) {
        int j[UNROLL];
        T v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const bool in = t + u < t1;
          j[u] = in ? targets[t + u] - c0 : -1;
          v[u] = in ? vals[t + u] : T(0);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          if ((unsigned)j[u] < (unsigned)nc) {
            my_j[cnt] = j[u];
            my_v[cnt] = v[u];
            ++cnt;
          }
      }
    }
    __syncwarp();
    // accumulate: the batch's trials in ascending order
    const int nb = min(LANES, r1 - base);
    for (int q = 0; q < nb; ++q) {
      const int cq = __shfl_sync(0xffffffffu, cnt, q);
      const T aq = __shfl_sync(0xffffffffu, a, q);
      for (int p = lane; p < cq; p += LANES) {
        const int c = stage_j[q * stride + p];
        row[c] = fma_rn(aq, stage_v[q * stride + p], row[c]);
      }
      __syncwarp();
    }
  }

  T* out = G + (long long)i * N + c0;
  for (int c = lane; c < nc; c += LANES) out[c] = row[c];
}

template <typename T>
int launch(const void* lam, const void* row_ptr, const void* row_trials,
           const void* row_pos, const void* trial_ptr, const void* targets,
           const void* trials, void* vals, void* G, int N, int K, int nnz,
           int stride, int width, int gather_blocks, void* stream) {
  if (N < 0 || K < 0 || nnz < 0 || stride < 0 || width < 1 ||
      gather_blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  if (nnz > 0)
    costim_gram_gather_kernel<T><<<gather_blocks, GATHER, 0, s>>>(
        (const T*)lam, (const int*)targets, (const int*)trials, (T*)vals, nnz,
        K);
  const dim3 grid(N, (N + width - 1) / width);
  const size_t smem = (size_t)(width + LANES * stride) * sizeof(T) +
                      (size_t)LANES * stride * sizeof(int);
  costim_gram_kernel<T><<<grid, LANES, smem, s>>>(
      (const T*)vals, (const int*)row_ptr, (const int*)row_trials,
      (const int*)row_pos, (const int*)trial_ptr, (const int*)targets, (T*)G,
      N, stride, width);
  return (int)cudaGetLastError();
}

}  // namespace cm_gram

// lam [N, K] contiguous; row_ptr [N + 1], row_trials [nnz] (each
// neuron's trials, ascending), row_pos [nnz] (where each of those sits
// in the trials' order), trial_ptr [K + 1], targets and trials [nnz]
// (each trial's distinct targets, in the trials' order), all int32;
// vals [nnz] scratch; G [N, N] contiguous, written whole. stride: a
// lane's staging slots (odd, at least the most targets a trial holds);
// width: the columns a block; gather_blocks: the gather's blocks
// (ops/gram_cuda.py::plan; shared memory at most 48 KB). Enqueued on
// `stream`, no synchronise; returns cudaGetLastError().
#define CM_COSTIM_GRAM(name, T)                                              \
  extern "C" int name(const void* lam, const void* row_ptr,                  \
                      const void* row_trials, const void* row_pos,           \
                      const void* trial_ptr, const void* targets,            \
                      const void* trials, void* vals, void* G, int N, int K, \
                      int nnz, int stride, int width, int gather_blocks,     \
                      void* stream) {                                        \
    return cm_gram::launch<T>(lam, row_ptr, row_trials, row_pos, trial_ptr,  \
                              targets, trials, vals, G, N, K, nnz, stride,   \
                              width, gather_blocks, stream);                 \
  }

CM_COSTIM_GRAM(cm_costim_gram_f32, float)
CM_COSTIM_GRAM(cm_costim_gram_f64, double)
