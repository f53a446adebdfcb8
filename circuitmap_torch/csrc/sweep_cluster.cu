// The cluster sweep's C entry points, and its instantiations at 1..4
// power levels. The kernel: sweep_cluster.cuh.

#include "sweep_cluster.cuh"

CM_SWEEP_DEFINE_RANGE(1)

namespace {

// the source file (range of P) that instantiates the kernel at P levels
cm_sweep::LaunchFn launch_range(int P) {
  using namespace cm_sweep;
  const LaunchFn fns[] = {launch_from_1, launch_from_5, launch_from_9,
                          launch_from_13};
  return fns[(P - 1) / 4];
}

cm_sweep::ActiveFn active_range(int P) {
  using namespace cm_sweep;
  const ActiveFn fns[] = {active_from_1, active_from_5, active_from_9,
                          active_from_13};
  return fns[(P - 1) / 4];
}

}  // namespace

// Pointers: y, mask, r [E, K]; stim, lam, out [E, N, K]; mu, beta, m0, m1
// [E, N]; counts [E, N, P]; powers [P]; steps [E, nsteps] int32 (block
// indices for rows_per_step > 1, rows for 1); scalars [E, 4] = (sig,
// msrmp_eff, min_count, gate_active). r holds mu @ lam on entry and is
// overwritten. All float32 unless stated, contiguous, on the device.
// rows_per_step 1..32, P 1..16. cluster, cols, on_chip, depth and
// smem_bytes come from the host's cluster_plan. Returns the cudaError_t
// of the launch (0 on success).
extern "C" int cm_sweep_cluster_f32(
    const void* y, const void* mask, const void* stim, const void* lam,
    const void* mu, const void* beta, const void* m0, const void* m1,
    const void* counts, const void* powers, const void* steps,
    const void* scalars, void* r, void* out, int E, int N, int K, int P,
    int nsteps, int rows_per_step, int cluster, int cols, int on_chip,
    int depth, int smem_bytes, void* stream) {
  const cm_sweep::Args args{
      (const float*)y,      (const float*)mask,   (const float*)stim,
      (const float*)lam,    (const float*)mu,     (const float*)beta,
      (const float*)m0,     (const float*)m1,     (const float*)counts,
      (const float*)powers, (const int*)steps,    (const float*)scalars,
      (float*)r,            (float*)out,          N,
      K,                    nsteps,               rows_per_step,
      cols,                 depth};
  if (cols % 4 != 0 || depth < 0 || depth > 4 || cluster < 1 ||
      rows_per_step < 1 || rows_per_step > cm_sweep::MAX_ROWS || P < 1 ||
      P > cm_sweep::MAX_P)
    return (int)cudaErrorInvalidValue;
  return launch_range(P)(P, args, E, cluster, on_chip, smem_bytes,
                         (cudaStream_t)stream);
}

// How many clusters of `cluster` CTAs with smem_bytes of dynamic shared
// memory (r on chip or not) the card can hold at once (0: it cannot
// launch one); a negative value is a cudaError_t.
extern "C" int cm_sweep_cluster_active(int rows_per_step, int P, int cluster,
                                       int on_chip, int smem_bytes) {
  if (rows_per_step < 1 || rows_per_step > cm_sweep::MAX_ROWS || P < 1 ||
      P > cm_sweep::MAX_P)
    return -(int)cudaErrorInvalidValue;
  return active_range(P)(P, rows_per_step, cluster, on_chip, smem_bytes);
}
