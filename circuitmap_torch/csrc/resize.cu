// The U-Net up blocks' epilogue for sm_90a: ReLU, the linear resize and
// the skip concat in one pass.
//
// Replaces no TPU kernel. The JAX package writes the resize as an XLA
// gather and lerp (circuitmap_tpu/demix/unet.py::resize_linear) and the
// concat as jnp.concatenate; the port ran them as three ATen kernels:
// relu, upsample_linear1d and cat. ATen's upsample_linear1d gives one
// thread to each output sample and loops over batch x channels inside
// it, so a launch has at most L_out (<= 900) threads and a few SMs do
// all the work: at the demixer's 4096-row chunks it took ~330 ms of a
// ~440 ms demix. The concat behind it read and wrote the same bytes
// again.
//
// out[b, c, j]      = relu(h[b, c, lo[j]]) * (1 - frac[j])
//                   + relu(h[b, c, hi[j]]) * frac[j],     c < C
// out[b, C + s, j]  = skip[b, s, j],                      s < Cs
//
// The taps (lo, hi, frac) come from the wrapper (ops/resize_cuda.py::
// _resize_taps, ATen's align_corners=False positions); the kernel does
// no index arithmetic of its own.
//
// What bounds it on this card: bytes. Each element of h and skip is
// read once and each output written once (43,248 floats a 900-sample
// trace over the four up blocks); the arithmetic is two multiplies a
// sample.
//
// What this design does about it:
// - One block a (row, group of channels): a row's G channels (all C of
//   them at the U-Net's shapes, <= 12.9 KB in float) go to shared memory
//   in one coalesced pass, 16-byte vectors where aligned, with ReLU on
//   load. A 4096-row chunk launches 4096 blocks of 256 threads, against
//   ATen's <= 900 threads. A line longer than a block's 48 KB is not
//   staged: one block a (row, channel) then reads its taps from h.
// - The lanes then write consecutive output samples of the group's
//   lines, coalesced, reading the two taps from shared memory and the
//   tap table (<= 900 entries, shared by every block) through L1.
// - The group's share of the row's skip, Cs * L_out contiguous elements
//   of both tensors, is copied in 16-byte vectors where aligned.
// - The lerp is ATen's: w0 = 1 - frac in the arithmetic type, then
//   w0 * x0 + frac * x1 as one product and one fused multiply-add, the
//   contraction nvcc makes of ATen's expression, written out so that no
//   flag can change it. Built without --use_fast_math. No atomics: the
//   result repeats bit for bit.
// - float, double, bfloat16 and half instances. The arithmetic type is
//   ATen's accscalar_t: double for double, float for the others (the
//   16-bit types load, take the ReLU and the lerp in float, with float
//   taps, and round once on the store, to nearest even).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

// ATen's accscalar_t of each storage type
template <typename T>
struct Acc {
  using type = T;
};
template <>
struct Acc<__nv_bfloat16> {
  using type = float;
};
template <>
struct Acc<__half> {
  using type = float;
};

__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ double to_acc(double x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_acc(__half x) { return __half2float(x); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(double* p, double v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store(__half* p, float v) {
  *p = __float2half_rn(v);
}

// F.relu: NaN passes through, -0 and negatives become 0
__device__ __forceinline__ float relu(float x) { return x <= 0.0f ? 0.0f : x; }
__device__ __forceinline__ double relu(double x) { return x <= 0.0 ? 0.0 : x; }
__device__ __forceinline__ __nv_bfloat16 relu(__nv_bfloat16 x) {
  return __bfloat162float(x) <= 0.0f ? __float2bfloat16_rn(0.0f) : x;
}
__device__ __forceinline__ __half relu(__half x) {
  return __half2float(x) <= 0.0f ? __float2half_rn(0.0f) : x;
}

// ReLU on each of the 16 / sizeof(T) elements of a 16-byte vector
template <typename T>
__device__ __forceinline__ uint4 relu16(uint4 v) {
  T* e = reinterpret_cast<T*>(&v);
#pragma unroll
  for (int k = 0; k < (int)(16 / sizeof(T)); ++k) e[k] = relu(e[k]);
  return v;
}

__device__ __forceinline__ float lerp(float x0, float x1, float f) {
  return __fmaf_rn(1.0f - f, x0, __fmul_rn(f, x1));
}
__device__ __forceinline__ double lerp(double x0, double x1, double f) {
  return __fma_rn(1.0 - f, x0, __dmul_rn(f, x1));
}

// Copy n elements, src to dst, by the block's threads; 16-byte vectors
// when VEC (both addresses then lie on a 16-byte boundary).
template <typename T, bool VEC>
__device__ __forceinline__ void copy_skip(T* __restrict__ dst,
                                          const T* __restrict__ src,
                                          long long n) {
  long long done = 0;
  if (VEC) {
    constexpr int per = 16 / sizeof(T);
    const long long nv = n / per;
    for (long long i = threadIdx.x; i < nv; i += blockDim.x)
      reinterpret_cast<uint4*>(dst)[i] =
          __ldg(reinterpret_cast<const uint4*>(src) + i);
    done = nv * per;
  }
  for (long long i = done + threadIdx.x; i < n; i += blockDim.x)
    dst[i] = src[i];
}

// grid (B, groups): block (b, g) resizes channels [g*G, g*G + G) of row
// b and copies the g-th share of the row's skip. VEC: every row and
// group start, and every share bound, lies on a 16-byte boundary (the
// wrapper's plan). STAGED: the group's input lines go to shared memory
// first; else (G = 1, a line longer than shared memory) the taps are
// read from h, with the ReLU taken on each.
template <typename T, bool VEC, bool STAGED>
__global__ void __launch_bounds__(THREADS)
    relu_resize_cat_kernel(const T* __restrict__ h, const T* __restrict__ skip,
                           const int* __restrict__ lo,
                           const int* __restrict__ hi,
                           const typename Acc<T>::type* __restrict__ frac,
                           T* __restrict__ out, int C, int Cs, int L_in,
                           int L_out, int G, long long share) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const long long b = blockIdx.x;
  const int c0 = blockIdx.y * G;
  const int nc = min(G, C - c0);
  T* row = out + b * (C + Cs) * (long long)L_out;

  // the group's input lines, ReLU on load
  const T* src = h + (b * C + c0) * (long long)L_in;
  const T* xs = src;
  if (STAGED) {
    T* st = reinterpret_cast<T*>(smem);
    const int n_in = nc * L_in;
    int done = 0;
    if (VEC) {
      constexpr int per = 16 / sizeof(T);
      const int nv = n_in / per;
      for (int i = threadIdx.x; i < nv; i += blockDim.x)
        reinterpret_cast<uint4*>(st)[i] =
            relu16<T>(__ldg(reinterpret_cast<const uint4*>(src) + i));
      done = nv * per;
    }
    for (int i = done + threadIdx.x; i < n_in; i += blockDim.x)
      st[i] = relu(src[i]);
    __syncthreads();
    xs = st;
  }

  // the resized lines: flat index i = c * L_out + j over the group,
  // (c, j) stepped by the block's stride without a division a sample
  T* dst = row + (long long)c0 * L_out;
  const int n_out = nc * L_out;
  const int dc = blockDim.x / L_out, dj = blockDim.x % L_out;
  int c = threadIdx.x / L_out, j = threadIdx.x % L_out;
  for (int i = threadIdx.x; i < n_out; i += blockDim.x) {
    const T* x = xs + c * L_in;
    A x0 = to_acc(x[__ldg(lo + j)]), x1 = to_acc(x[__ldg(hi + j)]);
    if (!STAGED) {
      x0 = relu(x0);
      x1 = relu(x1);
    }
    store(dst + i, lerp(x0, x1, __ldg(frac + j)));
    c += dc;
    j += dj;
    if (j >= L_out) {
      j -= L_out;
      ++c;
    }
  }

  // this group's share of the skip's row
  if (Cs > 0) {
    const long long n_skip = (long long)Cs * L_out;
    const long long s0 = min(n_skip, blockIdx.y * share);
    const long long s1 = min(n_skip, s0 + share);
    copy_skip<T, VEC>(row + (long long)C * L_out + s0, skip + b * n_skip + s0,
                      s1 - s0);
  }
}

template <typename T, bool VEC, bool STAGED>
void enqueue(dim3 grid, size_t smem, cudaStream_t s, const void* h,
             const void* skip, const void* lo, const void* hi,
             const void* frac, void* out, int C, int Cs, int L_in, int L_out,
             int G, long long share) {
  relu_resize_cat_kernel<T, VEC, STAGED><<<grid, THREADS, smem, s>>>(
      (const T*)h, (const T*)skip, (const int*)lo, (const int*)hi,
      (const typename Acc<T>::type*)frac, (T*)out, C, Cs, L_in, L_out, G,
      share);
}

template <typename T>
int launch(const void* h, const void* skip, const void* lo, const void* hi,
           const void* frac, void* out, int B, int C, int Cs, int L_in,
           int L_out, int G, long long share, int vec, int staged,
           void* stream) {
  if (B < 0 || C < 1 || Cs < 0 || L_in < 1 || L_out < 1 || G < 1 ||
      (!staged && G != 1) || (Cs > 0 && (skip == nullptr || share < 1)))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const dim3 grid(B, (C + G - 1) / G);
  const size_t smem = staged ? (size_t)G * L_in * sizeof(T) : 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (staged && vec)
    enqueue<T, true, true>(grid, smem, s, h, skip, lo, hi, frac, out, C, Cs,
                           L_in, L_out, G, share);
  else if (staged)
    enqueue<T, false, true>(grid, smem, s, h, skip, lo, hi, frac, out, C, Cs,
                            L_in, L_out, G, share);
  else if (vec)
    enqueue<T, true, false>(grid, smem, s, h, skip, lo, hi, frac, out, C, Cs,
                            L_in, L_out, G, share);
  else
    enqueue<T, false, false>(grid, smem, s, h, skip, lo, hi, frac, out, C, Cs,
                             L_in, L_out, G, share);
  return (int)cudaGetLastError();
}

}  // namespace

// h [B, C, L_in], skip [B, Cs, L_out] (nullptr when Cs = 0), lo, hi
// [L_out] int32, frac [L_out] in the arithmetic type (double for
// double, else float), out [B, C + Cs, L_out]; all contiguous on one
// device. G channels a block (staged: G * L_in elements of shared
// memory, at most 48 KB; unstaged: G = 1), `share` skip elements a
// block, `vec` the 16-byte path (ops/resize_cuda.py::plan). Enqueued on
// `stream`, no synchronise; returns cudaGetLastError().
#define CM_RELU_RESIZE_CAT(name, T)                                          \
  extern "C" int name(const void* h, const void* skip, const void* lo,       \
                      const void* hi, const void* frac, void* out, int B,    \
                      int C, int Cs, int L_in, int L_out, int G,             \
                      long long share, int vec, int staged, void* stream) {  \
    return launch<T>(h, skip, lo, hi, frac, out, B, C, Cs, L_in, L_out, G,   \
                     share, vec, staged, stream);                            \
  }

CM_RELU_RESIZE_CAT(cm_relu_resize_cat_f32, float)
CM_RELU_RESIZE_CAT(cm_relu_resize_cat_f64, double)
CM_RELU_RESIZE_CAT(cm_relu_resize_cat_bf16, __nv_bfloat16)
CM_RELU_RESIZE_CAT(cm_relu_resize_cat_f16, __half)
