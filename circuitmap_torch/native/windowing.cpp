// Host runtime of circuitmap_torch: continuous-recording window
// extraction + charge, the stim sparsify and the trace-wire codecs.
//
// The port's own copy of circuitmap_tpu/native/windowing.cpp, with the
// same exported C names and arithmetic. A mapping session records one
// long 20 kHz current trace; analysis operates on K response windows of
// W samples around each stimulus, integrated to a trapezoidal charge.
// For hour-long recordings (hundreds of millions of samples) a numpy
// gather burns single-core Python time before the GPU sees any data;
// this library does the gather and the reduction in parallel streaming
// passes, and the stim sparsify and trace-wire codecs likewise.
//
// Build (circuitmap_torch/utils/native.py, at first use):
//   g++ -O3 -ffp-contract=off -shared -fPIC -std=c++17 -pthread
// (-ffp-contract=off: the encoders' x / scale and the int4d2 decode
// upsample must stay bit-for-bit equal to the numpy/device mul+add; an
// FMA contraction would change their rounding on FMA targets)
// ABI: plain C, used via ctypes.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <type_traits>
#include <vector>

namespace {

inline int n_workers(long work_items) {
    unsigned hw = std::thread::hardware_concurrency();
    if (hw == 0) hw = 4;
    long cap = std::max(1L, work_items / 16);
    return static_cast<int>(std::min<long>(hw, cap));
}

template <typename Fn>
void parallel_for(long n, Fn&& fn) {
    int workers = n_workers(n);
    if (workers <= 1) {
        for (long i = 0; i < n; ++i) fn(i);
        return;
    }
    std::atomic<long> next(0);
    std::vector<std::thread> pool;
    pool.reserve(workers);
    for (int w = 0; w < workers; ++w) {
        pool.emplace_back([&] {
            for (;;) {
                long i = next.fetch_add(1);
                if (i >= n) return;
                fn(i);
            }
        });
    }
    for (auto& t : pool) t.join();
}

}  // namespace

extern "C" {

// Extract K windows of length W starting at stim_times[k] - pre from a
// float32 timeline of T samples. Out-of-range samples are zero-filled
// (windows near the recording edges). out_windows: [K * W].
void cm_extract_windows(const float* timeline, int64_t T,
                        const int64_t* stim_times, int64_t K,
                        int64_t pre, int64_t W, float* out_windows) {
    parallel_for(K, [&](long k) {
        const int64_t start = stim_times[k] - pre;
        float* dst = out_windows + k * W;
        // clamp both bounds to [0, W]: a stim time far before the
        // recording start would otherwise zero-fill past the row end
        const int64_t lo = std::min<int64_t>(W, std::max<int64_t>(0, -start));
        const int64_t hi = std::min<int64_t>(W, std::max<int64_t>(0, T - start));
        for (int64_t j = 0; j < lo; ++j) dst[j] = 0.0f;
        for (int64_t j = std::max<int64_t>(lo, 0); j < hi; ++j)
            dst[j] = timeline[start + j];
        for (int64_t j = std::max<int64_t>(hi, 0); j < W; ++j) dst[j] = 0.0f;
    });
}

// Trapezoidal charge of each row of a [K, W] float32 trace block.
void cm_trapz_rows(const float* traces, int64_t K, int64_t W,
                   double* out_charge) {
    parallel_for(K, [&](long k) {
        const float* row = traces + k * W;
        double acc = 0.0;
        for (int64_t j = 1; j < W; ++j)
            acc += 0.5 * (static_cast<double>(row[j - 1]) + row[j]);
        out_charge[k] = acc;
    });
}

// Fused: windows + charges in one pass over the timeline.
void cm_extract_windows_with_charge(const float* timeline, int64_t T,
                                    const int64_t* stim_times, int64_t K,
                                    int64_t pre, int64_t W,
                                    float* out_windows, double* out_charge) {
    parallel_for(K, [&](long k) {
        const int64_t start = stim_times[k] - pre;
        float* dst = out_windows + k * W;
        const int64_t lo = std::min<int64_t>(W, std::max<int64_t>(0, -start));
        const int64_t hi = std::min<int64_t>(W, std::max<int64_t>(0, T - start));
        for (int64_t j = 0; j < lo; ++j) dst[j] = 0.0f;
        for (int64_t j = std::max<int64_t>(lo, 0); j < hi; ++j)
            dst[j] = timeline[start + j];
        for (int64_t j = std::max<int64_t>(hi, 0); j < W; ++j) dst[j] = 0.0f;
        double acc = 0.0;
        for (int64_t j = 1; j < W; ++j)
            acc += 0.5 * (static_cast<double>(dst[j - 1]) + dst[j]);
        out_charge[k] = acc;
    });
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Stimulus-matrix sparsification: dense [N, K] -> hologram wire format.
//
// The solvers upload the stimulus design in column-sparse form
// (solvers/_common._sparsify): [H, K] target indices + power buckets,
// where H = max targets per trial. The numpy path needs a bool-mask
// pass, a nonzero() and fancy-index writes (~0.1 s at N=1000, K=20000);
// this routine does it in ONE parallel pass, each thread streaming the
// row-major matrix restricted to its own column block (contiguous
// 8 B*W chunks per row), so within-column target order stays ascending
// in n without any sort. Also accumulates the per-neuron trial counts
// per power that the reconnection scan reuses.
//
// Returns H (the max column fill), -1 if any column exceeds h_cap
// (caller falls back to the dense path), or -2 if stim contains a
// value missing from the level table (caller raises).

namespace {

template <typename T>
int64_t sparsify_impl(const T* stim, int64_t N, int64_t K,
                      int64_t f_layout,
                      const float* levels, int64_t L, int64_t h_cap,
                      int16_t* targets, int8_t* tbucket,
                      double* power_counts) {
    const int64_t P = L - 1;
    unsigned hw = std::thread::hardware_concurrency();
    if (hw == 0) hw = 4;
    // one column block per worker; blocks of >=512 columns keep the
    // per-row read chunks comfortably larger than a cache line
    int workers = static_cast<int>(
        std::min<int64_t>(hw, std::max<int64_t>(1, K / 512)));
    const int64_t block = (K + workers - 1) / workers;

    std::vector<int64_t> h_max(workers, 0);
    std::vector<std::vector<double>> pc(
        workers, std::vector<double>(N * P, 0.0));
    std::atomic<bool> overflow(false);
    std::atomic<bool> mismatch(false);

    std::vector<std::thread> pool;
    pool.reserve(workers);
    for (int w = 0; w < workers; ++w) {
        pool.emplace_back([&, w] {
            const int64_t k0 = w * block;
            const int64_t k1 = std::min<int64_t>(K, k0 + block);
            if (k0 >= k1) return;
            std::vector<int32_t> cnt(k1 - k0, 0);
            double* my_pc = pc[w].data();
            // unsigned type with T's width, for the zero-run fast path
            using bits_t = typename std::conditional<
                sizeof(T) == 8, uint64_t, uint32_t>::type;
            if (f_layout) {
                // Fortran layout: element (n, k) lives at stim[k*N+n],
                // so each trial COLUMN is contiguous — iterate k outer
                // / n inner (sequential memory) instead of copying the
                // whole matrix to C order (the old ascontiguousarray
                // fallback cost ~180 ms for the 160 MB bench stim —
                // simulate() returns its design F-contiguous). Within-
                // column ascending n is exactly the wire's fill order.
                for (int64_t k = k0;
                     k < k1 && !overflow.load() && !mismatch.load(); ++k) {
                    const T* col = stim + k * N;
                    int32_t c = 0;
                    int64_t n = 0;
                    bool stop = false;
                    while (n < N && !stop) {
                        int64_t ne = (n + 8 <= N) ? n + 8 : N;
                        if (ne - n == 8) {
                            bits_t chunk[8];
                            std::memcpy(chunk, col + n, sizeof(chunk));
                            bits_t acc = chunk[0];
                            for (int j = 1; j < 8; ++j) acc |= chunk[j];
                            if (acc == 0) {
                                n = ne;
                                continue;
                            }
                        }
                        for (; n < ne; ++n) {
                            const T v = col[n];
                            if (v == static_cast<T>(0)) continue;
                            const int32_t slot = c++;
                            if (slot >= h_cap) {
                                overflow.store(true);
                                stop = true;
                                break;
                            }
                            const float vf = static_cast<float>(v);
                            int64_t b = 0;
                            while (b < L && levels[b] < vf) ++b;
                            if (b >= L || levels[b] != vf) {
                                mismatch.store(true);
                                stop = true;
                                break;
                            }
                            targets[slot * K + k] = static_cast<int16_t>(n);
                            tbucket[slot * K + k] = static_cast<int8_t>(b);
                            my_pc[n * P + (b - 1)] += 1.0;
                        }
                    }
                    cnt[k - k0] = c;
                }
                int64_t hm = 0;
                for (int32_t c : cnt) hm = std::max<int64_t>(hm, c);
                h_max[w] = hm;
                return;
            }
            for (int64_t n = 0;
                 n < N && !overflow.load() && !mismatch.load(); ++n) {
                const T* row = stim + n * K;
                bool stop = false;
                int64_t k = k0;
                while (k < k1 && !stop) {
                    // Zero-run fast path: stim is typically >90% zeros
                    // and +0.0 is the all-zero bit pattern, so one
                    // 8-wide bitwise OR of the raw element bits skips
                    // a whole chunk (vectorisable; the scalar loop ran
                    // ~11 ns/element on this host — 220 ms for the
                    // 160 MB bench stim). -0.0 / nonzero chunks fall
                    // through to the exact scalar path below.
                    int64_t ke = (k + 8 <= k1) ? k + 8 : k1;
                    if (ke - k == 8) {
                        bits_t chunk[8];
                        std::memcpy(chunk, row + k, sizeof(chunk));
                        bits_t acc = chunk[0];
                        for (int j = 1; j < 8; ++j) acc |= chunk[j];
                        if (acc == 0) {
                            k = ke;
                            continue;
                        }
                    }
                    for (; k < ke; ++k) {
                        const T v = row[k];
                        if (v == static_cast<T>(0)) continue;
                        const int32_t slot = cnt[k - k0]++;
                        if (slot >= h_cap) {
                            overflow.store(true);
                            stop = true;
                            break;
                        }
                        // searchsorted(levels, v) on the tiny level
                        // table, comparing in f32 exactly as the numpy
                        // path does
                        const float vf = static_cast<float>(v);
                        int64_t b = 0;
                        while (b < L && levels[b] < vf) ++b;
                        if (b >= L || levels[b] != vf) {
                            // value not in the level table: a
                            // mismatched powers= argument — report
                            // instead of silently mis-bucketing
                            mismatch.store(true);
                            stop = true;
                            break;
                        }
                        targets[slot * K + k] = static_cast<int16_t>(n);
                        tbucket[slot * K + k] = static_cast<int8_t>(b);
                        my_pc[n * P + (b - 1)] += 1.0;
                    }
                }
            }
            int64_t hm = 0;
            for (int32_t c : cnt) hm = std::max<int64_t>(hm, c);
            h_max[w] = hm;
        });
    }
    for (auto& t : pool) t.join();
    if (mismatch.load()) return -2;
    if (overflow.load()) return -1;

    int64_t H = 0;
    for (int w = 0; w < workers; ++w) {
        H = std::max(H, h_max[w]);
        const double* src = pc[w].data();
        for (int64_t i = 0; i < N * P; ++i) power_counts[i] += src[i];
    }
    return H;
}

}  // namespace

extern "C" {

// f_layout: 0 = C-contiguous rows, 1 = Fortran-contiguous columns, so
// neither layout needs a 160 MB relayout copy. (The "2" in the names
// is the JAX package's ABI version, kept so the two libraries export
// the same symbols.)
int64_t cm_sparsify_stim2_f64(const double* stim, int64_t N, int64_t K,
                              int64_t f_layout,
                              const float* levels, int64_t L, int64_t h_cap,
                              int16_t* targets, int8_t* tbucket,
                              double* power_counts) {
    return sparsify_impl(stim, N, K, f_layout, levels, L, h_cap, targets,
                         tbucket, power_counts);
}

int64_t cm_sparsify_stim2_f32(const float* stim, int64_t N, int64_t K,
                              int64_t f_layout,
                              const float* levels, int64_t L, int64_t h_cap,
                              int16_t* targets, int8_t* tbucket,
                              double* power_counts) {
    return sparsify_impl(stim, N, K, f_layout, levels, L, h_cap, targets,
                         tbucket, power_counts);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fused trace-wire encoders.
//
// The quantised upload wires (demix/demixer.py int4/int4d2 paths,
// solvers/_common.prepare_traces, serve's HTTP psc bodies) encode each
// host chunk with several numpy passes: cast-to-f32, antialias
// mean-pool, |x| peak, rint divide, clip, two strided nibble ops —
// ~6 passes (~80-90 MB of traffic for a [4096, 900] f64 chunk) in
// front of a ~1 MB transfer. These routines stream the SOURCE dtype
// once per row and emit codes + scale directly.
//
// The arithmetic must stay bit-for-bit identical to the numpy
// reference (utils/quant.quantise_pack_int4 / quantise_int8 composed
// with utils/quant._pool2), because the QAT demixer checkpoints are
// trained against exactly that transform:
//   * every sample is cast to f32 BEFORE any arithmetic (the
//     '.5-boundary' rule) — pooling is 0.5f * (a + b) in f32;
//   * scale = f32 |peak| / qmax, 1.0f for all-zero rows;
//   * codes = nearbyint(v / scale) (round-half-to-even, like np.rint)
//     in f32, clipped to [-qmax, qmax] for int4;
//   * int4 packs two's-complement nibbles (low = even sample).
//
// Returns 0, or -1 if any (pooled) sample is non-finite — callers
// raise, exactly like the numpy wire does on a non-finite scale.

namespace {

// Round-half-to-even of a bounded value, matching np.rint /
// nearbyintf bit-for-bit for |x| < 2^51 (the wire codes are bounded
// by qmax * (1 + eps)), but branchless and auto-vectorisable — a
// libm nearbyintf call per sample made the encoder SLOWER than the
// numpy pipeline it replaces.
inline int round_half_even(float x) {
    constexpr double kMagic = 6755399441055744.0;  // 2^52 + 2^51
    return static_cast<int>(
        (static_cast<double>(x) + kMagic) - kMagic);
}

template <typename T, int BITS>
int64_t encode_impl(const T* src, int64_t B, int64_t T_len,
                    int64_t decimate, uint8_t* out, float* out_scale) {
    const float qmax = BITS == 4 ? 7.0f : 127.0f;
    const int64_t half = T_len / 2;
    const int64_t t2 = decimate == 2 ? half + (T_len % 2) : T_len;
    const int64_t out_w = BITS == 4 ? (t2 + 1) / 2 : t2;
    std::atomic<bool> bad(false);

    parallel_for(B, [&](long r) {
        thread_local std::vector<float> tmp;
        thread_local std::vector<int32_t> code_buf;
        tmp.resize(static_cast<size_t>(t2));
        code_buf.resize(static_cast<size_t>(t2 + 1));
        float* __restrict tp = tmp.data();
        int32_t* __restrict cp = code_buf.data();
        const T* __restrict row = src + r * T_len;

        // pass A: cast/pool into f32 scratch (pure elementwise)
        if (decimate == 2) {
            for (int64_t i = 0; i < half; ++i)
                tp[i] = 0.5f * (static_cast<float>(row[2 * i]) +
                                static_cast<float>(row[2 * i + 1]));
            if (T_len % 2) tp[t2 - 1] = static_cast<float>(row[T_len - 1]);
        } else {
            for (int64_t i = 0; i < t2; ++i)
                tp[i] = static_cast<float>(row[i]);
        }

        // pass B: |peak| and finiteness in ONE integer max reduction —
        // for IEEE floats the absolute-value bit patterns compare like
        // unsigned ints, with inf/nan above every finite value.
        // (memcpy, not a uint32_t* cast: two restrict pointers of
        // different types aliasing tmp is UB; memcpy of 4 bytes
        // compiles to the same plain load)
        uint32_t imax = 0;
        for (int64_t i = 0; i < t2; ++i) {
            uint32_t m;
            std::memcpy(&m, tp + i, sizeof(m));
            m &= 0x7fffffffu;
            imax = m > imax ? m : imax;
        }
        if (imax >= 0x7f800000u) {  // inf or nan somewhere in the row
            bad.store(true);
            return;
        }
        float peak;
        std::memcpy(&peak, &imax, sizeof(peak));
        float scale = peak / qmax;
        if (!(scale > 0.0f)) scale = 1.0f;
        out_scale[r] = scale;

        // pass C: quantise (vectorisable div/round/clamp)
        if (BITS == 4) {
            for (int64_t i = 0; i < t2; ++i) {
                const int q = round_half_even(tp[i] / scale);
                cp[i] = std::min(7, std::max(-7, q));
            }
            cp[t2] = 0;  // odd-length pad nibble
            uint8_t* __restrict dst = out + r * out_w;
            for (int64_t i = 0; i < t2; i += 2)
                dst[i / 2] = static_cast<uint8_t>(
                    (cp[i] & 0x0F) | ((cp[i + 1] & 0x0F) << 4));
        } else {
            // int8: no clip, matching numpy's rint + unsafe cast (the
            // ratio is bounded by qmax * (1 + eps), so rint never
            // exceeds 127 anyway)
            int8_t* __restrict dst =
                reinterpret_cast<int8_t*>(out) + r * out_w;
            for (int64_t i = 0; i < t2; ++i)
                dst[i] = static_cast<int8_t>(
                    round_half_even(tp[i] / scale));
        }
    });
    return bad.load() ? -1 : 0;
}

}  // namespace

extern "C" {

int64_t cm_encode_traces_int4_f64(const double* src, int64_t B, int64_t T,
                                  int64_t decimate, uint8_t* out,
                                  float* out_scale) {
    return encode_impl<double, 4>(src, B, T, decimate, out, out_scale);
}

int64_t cm_encode_traces_int4_f32(const float* src, int64_t B, int64_t T,
                                  int64_t decimate, uint8_t* out,
                                  float* out_scale) {
    return encode_impl<float, 4>(src, B, T, decimate, out, out_scale);
}

int64_t cm_encode_traces_int8_f64(const double* src, int64_t B, int64_t T,
                                  int64_t decimate, uint8_t* out,
                                  float* out_scale) {
    return encode_impl<double, 8>(src, B, T, decimate, out, out_scale);
}

int64_t cm_encode_traces_int8_f32(const float* src, int64_t B, int64_t T,
                                  int64_t decimate, uint8_t* out,
                                  float* out_scale) {
    return encode_impl<float, 8>(src, B, T, decimate, out, out_scale);
}

// Fused int4 trace-wire DECODE: nibble-unpack + dequantise (+ the
// int4d2 wire's linear 2x upsample) in one pass per row, emitting
// dense f32 [B, t_true]. The numpy decode (utils/quant
// unpack_int4_codes: int32 widen, two mask/shift passes, a stack/
// reshape, an astype, a scale multiply, then _upsample2's three more
// passes) costs ~340 ms at the flagship [20000, 900] shape — all in
// front of the server handing the traces BACK to an encoder. The
// arithmetic here must match the numpy/device reference bit-for-bit:
//   * codes are two's-complement nibbles (low = even sample);
//   * sample = f32(code) * scale[r] (exact: |code| <= 7);
//   * upsample (decimate == 2, _upsample2): even out = 0.75f*p[i] +
//     0.25f*p[i-1], odd out = 0.75f*p[i] + 0.25f*p[i+1], edges
//     clamped, trimmed to t_true.
// packed row stride is ceil(t2/2) bytes where t2 = ceil(t_true/2) for
// decimate == 2 else t_true. Returns 0 (no failure modes: any byte
// decodes).
int64_t cm_decode_traces_int4(const uint8_t* packed, int64_t B,
                              int64_t t_true, int64_t decimate,
                              const float* scale, float* out) {
    const int64_t t2 = decimate == 2 ? (t_true + 1) / 2 : t_true;
    const int64_t stride = (t2 + 1) / 2;
    parallel_for(B, [&](long r) {
        thread_local std::vector<float> tmp;
        const uint8_t* __restrict src = packed + r * stride;
        const float s = scale[r];
        float* __restrict dst;
        if (decimate == 2) {
            tmp.resize(static_cast<size_t>(t2));
            dst = tmp.data();
        } else {
            dst = out + r * t_true;
        }
        for (int64_t i = 0; i < t2; ++i) {
            const uint8_t byte = src[i >> 1];
            const int nib = (i & 1) ? (byte >> 4) : (byte & 0x0F);
            const int code = ((nib ^ 8) - 8);  // sign-extend 4 bits
            dst[i] = static_cast<float>(code) * s;
        }
        if (decimate == 2) {
            float* __restrict o = out + r * t_true;
            const float* __restrict p = tmp.data();
            for (int64_t i = 0; i < t2; ++i) {
                const float prev = p[i > 0 ? i - 1 : 0];
                const float nxt = p[i + 1 < t2 ? i + 1 : t2 - 1];
                const int64_t e = 2 * i, od = 2 * i + 1;
                if (e < t_true) o[e] = 0.75f * p[i] + 0.25f * prev;
                if (od < t_true) o[od] = 0.75f * p[i] + 0.25f * nxt;
            }
        }
    });
    return 0;
}

}  // extern "C"
