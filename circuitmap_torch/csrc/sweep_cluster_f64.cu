// The cluster sweep in double, for the float64 fits (kernel:
// sweep_cluster.cuh). Only the runtime-level form (P = 0) is
// instantiated, at one row a step and at a runtime row count, so every
// level count and block size runs and nvcc's time stays bounded: a
// float64 fit is a parity-oracle fit, whose speed is written down, not
// tuned. Its shared memory holds elements of 8 bytes, so r, y, mask and
// est stay on chip up to half the float32 form's K
// (ops/sweep_cuda.py::cluster_plan with item 8).

#include "sweep_cluster.cuh"

// The arguments of cm_sweep_cluster_f32 (sweep_cluster.cu), in double
// where that takes float32; xg is always given (P = 0 at every level
// count). Returns the cudaError_t of the launch (0 on success).
extern "C" int cm_sweep_cluster_f64(
    const void* y, const void* mask, const void* stim, const void* lam,
    const void* mu, const void* beta, const void* m0, const void* m1,
    const void* counts, const void* powers, const void* steps,
    const void* scalars, void* r, void* out, void* dacc, void* xg, int E,
    int N, int K, int P, int nsteps, int rows_per_step, int block, int subs,
    int cluster, int cols, int on_chip, int depth, int smem_bytes,
    void* stream) {
  const cm_sweep::Args64 args{
      (const double*)y,      (const double*)mask,   (const double*)stim,
      (const double*)lam,    (const double*)mu,     (const double*)beta,
      (const double*)m0,     (const double*)m1,     (const double*)counts,
      (const double*)powers, (const int*)steps,     (const double*)scalars,
      (double*)r,            (double*)out,          (double*)dacc,
      (double*)xg,           N,                     K,
      nsteps,                rows_per_step,         cols,
      depth,                 block,                 subs,
      P};
  if (cols % 4 != 0 || depth < 0 || depth > 4 || cluster < 1 ||
      rows_per_step < 1 || rows_per_step > cm_sweep::MAX_ROWS || P < 1 ||
      subs < 1 || block <= (subs - 1) * rows_per_step ||
      block > subs * rows_per_step || (rows_per_step == 1 && subs != 1) ||
      (subs > 1 && dacc == nullptr) || xg == nullptr)
    return (int)cudaErrorInvalidValue;
  return cm_sweep::detail::launch_f64(args, E, cluster, on_chip, smem_bytes,
                                      (cudaStream_t)stream);
}

// cm_sweep_cluster_active (sweep_cluster.cu) for the double form.
extern "C" int cm_sweep_cluster_active_f64(int rows_per_step, int P,
                                           int cluster, int on_chip,
                                           int smem_bytes) {
  if (rows_per_step < 1 || rows_per_step > cm_sweep::MAX_ROWS || P < 1)
    return -(int)cudaErrorInvalidValue;
  return cm_sweep::detail::active_f64(rows_per_step, cluster, on_chip,
                                      smem_bytes);
}
