// The cluster sweep's instantiations at 9..12 power levels (kernel:
// sweep_cluster.cuh; entry points: sweep_cluster.cu).

#include "sweep_cluster.cuh"

CM_SWEEP_DEFINE_RANGE(9)
