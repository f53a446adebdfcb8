// The cluster sweep's instantiation at a runtime level count above
// MAX_P (P = 0 in the kernel's template; kernel: sweep_cluster.cuh; entry
// points: sweep_cluster.cu).

#include "sweep_cluster.cuh"

namespace cm_sweep {

int launch_dyn(const Args& a, int E, int cluster, int on_chip, int smem,
               cudaStream_t s) {
  return detail::launch_p<0>(a, E, cluster, on_chip, smem, s);
}

int active_dyn(int rows, int cluster, int on_chip, int smem) {
  return detail::active_p<0>(rows, cluster, on_chip, smem);
}

}  // namespace cm_sweep
