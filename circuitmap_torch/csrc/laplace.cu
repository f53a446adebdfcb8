// Laplace power-curve refit for sm_90a.
//
// Replaces the Pallas TPU kernel circuitmap_tpu/ops/laplace_pallas.py::
// laplace_from_stats_pallas (body _laplace_kernel, :46-145). For each
// neuron, independently: 10 damped Newton steps on phi = (phi0, phi1)
// of the objective
//   -sum_p nan_to_num(S_p logsig(x_p) + (C_p - S_p) logsig(-x_p))
//   - (log phi0 + log phi1) / t + 0.5 dphi' prec dphi,   x_p = phi0 L_p - phi1,
// each step taking the first accepted Armijo step of 0.5^j, j = 0..40
// (a NaN candidate, e.g. log of a negative phi, is rejected; when none
// is accepted, 0.5^40). Returns phi and the inverse Hessian of the last
// direction evaluation (at phi_9) as the covariance.
//
// What bounds it on this card: neither bytes nor flops. The inputs are
// tens of KB and the work ~10^7 operations at N=1000; the launch and one
// neuron's dependent chain (10 steps of double exp/log1p/log and
// divisions, each step waiting on the last) set the time.
//
// What this design does about it:
// - Every neuron gets a group of GROUP lanes of one warp, and every
//   block is one warp, so N=1000 fills 500 blocks across all SMs and
//   four experiments' 4000 lanes 2000 blocks.
// - The lanes of a group compute the Newton direction identically
//   (gradient, Hessian, adjugate inverse), so nothing is broadcast, then
//   search the Armijo steps in parallel: in round r lane i evaluates
//   candidate j = r * GROUP + i, and the group's first acceptance is the
//   lowest set bit of its ballot, which is the sequential rule's first
//   acceptance and the Pallas kernel's masked max. A further round runs
//   only when no lane of the group accepted, up to j = 40. Groups of one
//   warp diverge only while one of them needs another round.
// - The next point is the accepted candidate itself, taken with its
//   objective from the accepting lane by __shfl_sync, so f0 of the next
//   step is never evaluated again and equals the objective at phi
//   exactly. Without an acceptance the lane that evaluated j = 40
//   supplies both (the step 0.5^40).
// - The bucket count P+1 <= 17 (16 power levels) is a template
//   parameter, so S, C and the levels sit in registers (fully unrolled
//   loops). Above 17 (P1 = 0 in the template) the count is a runtime
//   value and every loop over the buckets reads S, C and the levels
//   from device memory (L1), a simple layout that is right: speed at
//   many levels is later work. The launch bounds promise one block an SM at least: without
//   that, ptxas aims at a higher occupancy, caps a thread at 128 or 168
//   registers and spills from P+1 = 7 on; with it P+1 <= 16 uses 82-236
//   registers, no stack frame and no spills.
// - Arithmetic runs in double (inputs and outputs float32, or double for
//   the float64 fits through cm_laplace_f64, which takes the runtime
//   bucket count only: a parity-oracle fit's speed is not tuned): the
//   2x2 Hessian of closely spaced power levels is ill-conditioned, so
//   float32 arithmetic leaves ~3e-4 relative error in the covariance.
//   The speed comes from the parallel search and the spread over the
//   card, not from precision. Built without --use_fast_math: log of a
//   negative step candidate must give NaN for the rejection rule.
// - A prior shared by the experiments of a batch is read in place at
//   lane mod its row count.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int MAX_P1 = 17;  // bucket counts held in registers (fixed)
constexpr int NEWTON_STEPS = 10;
constexpr int MAX_BACKTRACK = 40;
constexpr double BARRIER_T = 10.0;
constexpr double ARMIJO_ALPHA = 0.25;
constexpr int GROUP = 16;    // lanes a neuron: Armijo candidates a round
constexpr int THREADS = 32;  // one warp a block, 32 / GROUP neurons
static_assert(32 % GROUP == 0, "a group lies within one warp");

__device__ __forceinline__ double log_sigmoid(double x) {
  return fmin(x, 0.0) - log1p(exp(-fabs(x)));
}

__device__ __forceinline__ double nan_to_num(double v) {
  if (isnan(v)) return 0.0;
  if (isinf(v)) return v > 0.0 ? DBL_MAX : -DBL_MAX;
  return v;
}

// One neuron's buckets: P1 > 0 in registers; P1 = 0, a runtime count
// `n`, read from device memory at each use. IO: the element type of the
// inputs and outputs (float, or double).
template <int P1, typename IO>
struct Buckets {
  double S[P1], C[P1], lev[P1];
  __device__ void load(const IO* s, const IO* c, const IO* l, int) {
#pragma unroll
    for (int p = 0; p < P1; ++p) S[p] = s[p], C[p] = c[p], lev[p] = l[p];
  }
  __device__ __forceinline__ int count() const { return P1; }
  __device__ __forceinline__ double s(int p) const { return S[p]; }
  __device__ __forceinline__ double c(int p) const { return C[p]; }
  __device__ __forceinline__ double l(int p) const { return lev[p]; }
};

template <typename IO>
struct Buckets<0, IO> {
  const IO *S, *C, *lev;
  int n;
  __device__ void load(const IO* s, const IO* c, const IO* l, int p1) {
    S = s, C = c, lev = l, n = p1;
  }
  __device__ __forceinline__ int count() const { return n; }
  __device__ __forceinline__ double s(int p) const { return S[p]; }
  __device__ __forceinline__ double c(int p) const { return C[p]; }
  __device__ __forceinline__ double l(int p) const { return lev[p]; }
};

template <int P1, typename IO>
struct Neuron {
  Buckets<P1, IO> b;
  double pr0, pr1;            // prior mean
  double q00, q01, q10, q11;  // prior precision

  __device__ __forceinline__ double objective(double c0, double c1) const {
    double acc = 0.0;
#pragma unroll
    for (int p = 0; p < b.count(); ++p) {
      const double x = c0 * b.l(p) - c1;
      const double ll =
          b.s(p) * log_sigmoid(x) + (b.c(p) - b.s(p)) * log_sigmoid(-x);
      acc -= nan_to_num(ll);
    }
    acc -= (log(c0) + log(c1)) / BARRIER_T;
    const double d0 = c0 - pr0, d1 = c1 - pr1;
    return acc + 0.5 * (d0 * (q00 * d0 + q01 * d1) +
                         d1 * (q10 * d0 + q11 * d1));
  }
};

template <int P1, typename IO = float>
__global__ void __launch_bounds__(THREADS, 1) laplace_kernel(
    const IO* __restrict__ S, const IO* __restrict__ C,
    const IO* __restrict__ levels, const IO* __restrict__ phi_prior,
    const IO* __restrict__ cov_prior, IO* __restrict__ phi_out,
    IO* __restrict__ cov_out, int N, int p1, int n_phi_prior,
    int n_cov_prior) {
  const int lane = threadIdx.x % 32;
  const int slot = lane % GROUP;  // this lane's candidate in a round
  const int first_lane = lane - slot;
  const unsigned group = (0xffffffffu >> (32 - GROUP)) << first_lane;
  const long long n = ((long long)blockIdx.x * THREADS + threadIdx.x) / GROUP;
  if (n >= N) return;  // the whole group leaves

  Neuron<P1, IO> nr;
  nr.b.load(S + n * p1, C + n * p1, levels, p1);
  const long long a = n % n_phi_prior, b = n % n_cov_prior;
  nr.pr0 = phi_prior[2 * a];
  nr.pr1 = phi_prior[2 * a + 1];
  {
    const double a00 = cov_prior[4 * b], a01 = cov_prior[4 * b + 1];
    const double a10 = cov_prior[4 * b + 2], a11 = cov_prior[4 * b + 3];
    const double det = a00 * a11 - a01 * a10;
    nr.q00 = a11 / det;
    nr.q01 = -a01 / det;
    nr.q10 = -a10 / det;
    nr.q11 = a00 / det;
  }

  double phi0 = nr.pr0, phi1 = nr.pr1;
  double f0 = nr.objective(phi0, phi1);
  double i00 = 0.0, i01 = 0.0, i10 = 0.0, i11 = 0.0;
#pragma unroll 1
  for (int it = 0; it < NEWTON_STEPS; ++it) {
    // Newton direction: gradient, Hessian, adjugate inverse
    double g0 = 0.0, g1 = 0.0, h00 = 0.0, h01 = 0.0, h11 = 0.0;
#pragma unroll
    for (int p = 0; p < nr.b.count(); ++p) {
      const double lv = nr.b.l(p), cp = nr.b.c(p);
      const double f = 1.0 / (1.0 + exp(-(phi0 * lv - phi1)));
      const double resid = nr.b.s(p) - cp * f;
      g0 -= lv * resid;
      g1 += resid;
      const double w = cp * f * (1.0 - f);
      h00 += lv * lv * w;
      h01 -= lv * w;
      h11 += w;
    }
    const double d0 = phi0 - nr.pr0, d1 = phi1 - nr.pr1;
    g0 += (nr.q00 * d0 + nr.q01 * d1) - 1.0 / (BARRIER_T * phi0);
    g1 += (nr.q10 * d0 + nr.q11 * d1) - 1.0 / (BARRIER_T * phi1);
    const double H00 = h00 + nr.q00 + 1.0 / (BARRIER_T * phi0 * phi0);
    const double H01 = h01 + nr.q01;
    const double H10 = h01 + nr.q10;
    const double H11 = h11 + nr.q11 + 1.0 / (BARRIER_T * phi1 * phi1);
    const double det = H00 * H11 - H01 * H10;
    i00 = H11 / det;
    i01 = -H01 / det;
    i10 = -H10 / det;
    i11 = H00 / det;
    const double v0 = -(i00 * g0 + i01 * g1);
    const double v1 = -(i10 * g0 + i11 * g1);
    const double gv = g0 * v0 + g1 * v1;

    // Armijo, GROUP candidates a round: this lane tries j = base + slot
    double c0 = phi0, c1 = phi1, lhs = f0;
    unsigned hit;
    for (int base = 0;; base += GROUP) {
      const int j = base + slot;
      bool ok = false;
      if (j <= MAX_BACKTRACK) {
        const double s = ldexp(1.0, -j);
        c0 = phi0 + s * v0;
        c1 = phi1 + s * v1;
        lhs = nr.objective(c0, c1);
        ok = !isnan(lhs) && lhs <= f0 + ARMIJO_ALPHA * s * gv;
      }
      hit = __ballot_sync(group, ok) & group;
      if (hit != 0 || base + GROUP > MAX_BACKTRACK) break;
    }
    // the first accepted candidate, else the last round's j = 40
    const int src = hit != 0 ? __ffs(hit) - 1
                             : first_lane + MAX_BACKTRACK % GROUP;
    phi0 = __shfl_sync(group, c0, src);
    phi1 = __shfl_sync(group, c1, src);
    f0 = __shfl_sync(group, lhs, src);
  }
  if (slot == 0) {
    phi_out[2 * n] = (IO)phi0;
    phi_out[2 * n + 1] = (IO)phi1;
    cov_out[4 * n] = (IO)i00;
    cov_out[4 * n + 1] = (IO)i01;
    cov_out[4 * n + 2] = (IO)i10;
    cov_out[4 * n + 3] = (IO)i11;
  }
}

template <typename IO>
struct ArgsT {
  const IO *S, *C, *levels, *phi_prior, *cov_prior;
  IO *phi_out, *cov_out;
  int N, n_phi_prior, n_cov_prior;
};
using Args = ArgsT<float>;

inline int blocks_for(int N) {
  const long long threads = (long long)N * GROUP;
  return (int)((threads + THREADS - 1) / THREADS);
}

// P1: the fixed bucket count that equals p1, or 0 (runtime) above MAX_P1
template <int P1>
int launch(int p1, const Args& a, cudaStream_t stream) {
  if constexpr (P1 > MAX_P1) {
    return launch<0>(p1, a, stream);
  } else {
    if (P1 > 0 && p1 != P1) return launch<P1 + 1>(p1, a, stream);
    laplace_kernel<P1><<<blocks_for(a.N), THREADS, 0, stream>>>(
        a.S, a.C, a.levels, a.phi_prior, a.cov_prior, a.phi_out, a.cov_out,
        a.N, p1, a.n_phi_prior, a.n_cov_prior);
    return (int)cudaGetLastError();
  }
}

// the double form: the runtime bucket count at every count
int launch_f64(int p1, const ArgsT<double>& a, cudaStream_t stream) {
  laplace_kernel<0, double><<<blocks_for(a.N), THREADS, 0, stream>>>(
      a.S, a.C, a.levels, a.phi_prior, a.cov_prior, a.phi_out, a.cov_out,
      a.N, p1, a.n_phi_prior, a.n_cov_prior);
  return (int)cudaGetLastError();
}

bool bad_shape(int N, int P1, int n_phi_prior, int n_cov_prior) {
  return P1 < 1 || N < 1 || n_phi_prior < 1 || n_cov_prior < 1 ||
         N % n_phi_prior != 0 || N % n_cov_prior != 0;
}

}  // namespace

// S, C [N, P1]; levels [P1]; phi_prior [n_phi_prior, 2] and cov_prior
// [n_cov_prior, 2, 2], lane n reading row n mod their count (a prior
// shared by the experiments of a batch is passed once); phi_out [N, 2];
// cov_out [N, 2, 2]. float32, contiguous, on the device. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int cm_laplace_f32(const void* S, const void* C,
                              const void* levels, const void* phi_prior,
                              const void* cov_prior, void* phi_out,
                              void* cov_out, int N, int P1, int n_phi_prior,
                              int n_cov_prior, void* stream) {
  if (bad_shape(N, P1, n_phi_prior, n_cov_prior))
    return (int)cudaErrorInvalidValue;
  const Args a{(const float*)S, (const float*)C, (const float*)levels,
               (const float*)phi_prior, (const float*)cov_prior,
               (float*)phi_out, (float*)cov_out, N, n_phi_prior,
               n_cov_prior};
  return launch<1>(P1, a, (cudaStream_t)stream);
}

// cm_laplace_f32 with double inputs and outputs (the float64 fits).
extern "C" int cm_laplace_f64(const void* S, const void* C,
                              const void* levels, const void* phi_prior,
                              const void* cov_prior, void* phi_out,
                              void* cov_out, int N, int P1, int n_phi_prior,
                              int n_cov_prior, void* stream) {
  if (bad_shape(N, P1, n_phi_prior, n_cov_prior))
    return (int)cudaErrorInvalidValue;
  const ArgsT<double> a{(const double*)S, (const double*)C,
                        (const double*)levels, (const double*)phi_prior,
                        (const double*)cov_prior, (double*)phi_out,
                        (double*)cov_out, N, n_phi_prior, n_cov_prior};
  return launch_f64(P1, a, (cudaStream_t)stream);
}

extern "C" const char* cm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
