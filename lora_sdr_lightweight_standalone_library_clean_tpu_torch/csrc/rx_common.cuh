// Pieces shared by the fused RX kernels (rx_dense.cu, rx_hybrid.cu and the
// entry points rx_osr.cu, stream_scan.cu, rotate_detect.cu): the window of
// one detection, its samples rotated and multiplied with the plain PyTorch
// version's rounding, the first-max rule and the dB epilogue.  Steps (a),
// (b) and (d) of rx_dense.cu's header.
//
// Four window readers instantiate the kernels; each says where a window's
// samples are and how one sample is formed (its `sample` member):
//   DirectReader  the osr == 1 packet window (window_of);
//   OsrReader     the decimated osr > 1 window and the halo variant of the
//                 TPU kernel's padded/slab and direct forms
//                 (ops/pallas_rx.py:_shifted_windows,
//                 _shifted_windows_direct); rx_osr.cu launches it;
//   StreamReader  every stride-aligned window of a continuous stream, times
//                 the scan down-chirp, with no rotation
//                 (ops/pallas_stream.py:_stream_kernel); stream_scan.cu;
//   RowReader     rows of windows already dechirped and windowed, rotated
//                 by start + rate*i (ops/pallas_detect.py:_detect_kernel);
//                 rotate_detect.cu.
#pragma once

#include <cuda_runtime.h>

namespace lora_rx {

__host__ __device__ constexpr int ilog2(int v) {
  return v <= 1 ? 0 : 1 + ilog2(v / 2);
}

// (v, k) wins over (bv, bk): the larger value, NaN counting as the
// largest, the lower index on ties.
__device__ __forceinline__ bool takes(float v, int k, float bv, int bk) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn || bn) return vn && (!bn || k < bk);
  return v > bv || (v == bv && k < bk);
}

struct Window {
  const float* row_r;   // first sample of the window
  const float* row_i;
  int stride;           // stream samples between window samples (osr)
  int avail;            // samples in the stream (StreamReader; 0..n)
  float rate;           // CFO derotation rate per sample
  float scale;          // per-packet amplitude normalisation
  float start;          // rotation phase of sample 0
};

// (a) window `win` = b * S + s of n samples: stream[b, s*n + t + i] with
// the reference's edge clamp (phy.cpp:209-216): symbol 0 reads unshifted
// when t < 0, symbol S-1 when t > 0.  start = rate * (s*n + t).
__device__ __forceinline__ Window window_of(
    const float* __restrict__ sr, const float* __restrict__ si,
    const int* __restrict__ t_off, const float* __restrict__ rate,
    const float* __restrict__ scale, int win, int S, int n) {
  const int b = win / S;
  const int s = win - b * S;
  int t = t_off[b];
  t = t < -n ? -n : (t > n ? n : t);     // callers pass |t| <= n already
  const bool unshifted = (s == 0 && t < 0) || (s == S - 1 && t > 0);
  const size_t base = (size_t)b * S * n + (size_t)s * n;
  Window w;
  w.row_r = sr + base + (unshifted ? 0 : t);
  w.row_i = si + base + (unshifted ? 0 : t);
  w.stride = 1;
  w.rate = rate[b];
  w.scale = scale[b];
  w.start = __fmul_rn(w.rate, (float)(s * n + t));
  return w;
}

// (a') #6: emitted window `win` = b * nd + e reads stream row s = h0 + e of
// S rows of step = n*osr samples: sample i = stream[b, s*step + t + i*osr]
// (decimation phase t mod osr, shift floor(t/osr) in the decimated
// domain), clamped with |t| <= step.  The edge clamp keys on the stream
// row: row 0 when t < 0 and row S-1 when t > 0 read the unshifted symbol
// at phase 0, stream[b, s*step + i*osr] (the reference decimates its
// unshifted base at phase 0).  The rotation starts at
// rate * (e*n + t/osr), one add as in the plain version, with the EMITTED
// row index e: the TPU kernel's s_col counts the detected rows of a halo
// call from 0 (ops/pallas_rx.py:551,632).
__device__ __forceinline__ Window window_of_osr(
    const float* __restrict__ sr, const float* __restrict__ si,
    const int* __restrict__ t_off, const float* __restrict__ rate,
    const float* __restrict__ scale, int win, int nd, int S, int n,
    int osr, int h0) {
  const int b = win / nd;
  const int e = win - b * nd;
  const int s = e + h0;
  const int step = n * osr;
  int t = t_off[b];
  t = t < -step ? -step : (t > step ? step : t);
  const bool unshifted = (s == 0 && t < 0) || (s == S - 1 && t > 0);
  const size_t base = (size_t)b * S * step + (size_t)s * step;
  Window w;
  w.row_r = sr + base + (unshifted ? 0 : t);
  w.row_i = si + base + (unshifted ? 0 : t);
  w.stride = osr;
  w.rate = rate[b];
  w.scale = scale[b];
  w.start = __fmul_rn(w.rate, __fadd_rn((float)(e * n),
                                        __fdiv_rn((float)t, (float)osr)));
  return w;
}

// (b) sample i: x * scale * e^{j(start + rate*i)} * mult[i], each product
// rounded as the plain version rounds it (no contraction into FMAs), with
// the accurate sincosf: the phase reaches hundreds of radians on raw
// chirps at sf12, where the fast intrinsic's error is no longer small.
__device__ __forceinline__ void rotated_sample(
    const Window& w, const float* __restrict__ mr,
    const float* __restrict__ mi, int i, float* out_r, float* out_i) {
  const float zr = __fmul_rn(__ldg(w.row_r + i * w.stride), w.scale);
  const float zi = __fmul_rn(__ldg(w.row_i + i * w.stride), w.scale);
  const float ph = __fadd_rn(w.start, __fmul_rn(w.rate, (float)i));
  float sn, cs;
  sincosf(ph, &sn, &cs);
  const float fr = __fsub_rn(__fmul_rn(zr, cs), __fmul_rn(zi, sn));
  const float fi = __fadd_rn(__fmul_rn(zr, sn), __fmul_rn(zi, cs));
  const float m_r = __ldg(mr + i);
  const float m_i = __ldg(mi + i);
  *out_r = __fsub_rn(__fmul_rn(fr, m_r), __fmul_rn(fi, m_i));
  *out_i = __fadd_rn(__fmul_rn(fr, m_i), __fmul_rn(fi, m_r));
}

// The osr == 1 reader: S windows per packet.
struct DirectReader {
  int S;
  __host__ __device__ int rows() const { return S; }
  __device__ __forceinline__ Window operator()(
      const float* __restrict__ sr, const float* __restrict__ si,
      const int* __restrict__ t_off, const float* __restrict__ rate,
      const float* __restrict__ scale, int win, int n) const {
    return window_of(sr, si, t_off, rate, scale, win, S, n);
  }
  __device__ __forceinline__ void sample(
      const Window& w, const float* __restrict__ mr,
      const float* __restrict__ mi, int i, float* out_r,
      float* out_i) const {
    rotated_sample(w, mr, mi, i, out_r, out_i);
  }
};

// The #6 reader: nd = S - h0 - h1 windows per packet out of S stream rows.
struct OsrReader {
  int nd, S, osr, h0;
  __host__ __device__ int rows() const { return nd; }
  __device__ __forceinline__ Window operator()(
      const float* __restrict__ sr, const float* __restrict__ si,
      const int* __restrict__ t_off, const float* __restrict__ rate,
      const float* __restrict__ scale, int win, int n) const {
    return window_of_osr(sr, si, t_off, rate, scale, win, nd, S, n, osr, h0);
  }
  __device__ __forceinline__ void sample(
      const Window& w, const float* __restrict__ mr,
      const float* __restrict__ mi, int i, float* out_r,
      float* out_i) const {
    rotated_sample(w, mr, mi, i, out_r, out_i);
  }
};

// The #7 reader: window `win` = b * W + w of stream b (len samples each)
// reads ext[b, w*stride + i*osr], i < n, and zero past the end of the
// stream (the plain version's zero padding).  Sample offsets are 64-bit:
// a stream may hold more than 2^31 samples.  Its sample is x * mult[i]
// with the plain version's rounding, and no scale or rotation (no sincos).
struct StreamReader {
  long long len;        // samples per stream
  int W;                // windows per stream
  int stride;           // samples between window starts
  int osr;              // samples between window samples
  __host__ __device__ int rows() const { return W; }
  __device__ __forceinline__ Window operator()(
      const float* __restrict__ sr, const float* __restrict__ si,
      const int* __restrict__ t_off, const float* __restrict__ rate,
      const float* __restrict__ scale, int win, int n) const {
    const int b = win / W;
    const int w = win - b * W;
    const long long first = (long long)w * stride;
    const long long left = len - first;
    const long long avail = left <= 0 ? 0 : (left + osr - 1) / osr;
    const size_t base = (size_t)b * (size_t)len + (size_t)first;
    Window out;
    out.row_r = sr + base;
    out.row_i = si + base;
    out.stride = osr;
    out.avail = avail < n ? (int)avail : n;
    out.rate = 0.f;
    out.scale = 1.f;
    out.start = 0.f;
    return out;
  }
  __device__ __forceinline__ void sample(
      const Window& w, const float* __restrict__ mr,
      const float* __restrict__ mi, int i, float* out_r,
      float* out_i) const {
    float zr = 0.f, zi = 0.f;
    if (i < w.avail) {
      zr = __ldg(w.row_r + (size_t)i * w.stride);
      zi = __ldg(w.row_i + (size_t)i * w.stride);
    }
    const float m_r = __ldg(mr + i);
    const float m_i = __ldg(mi + i);
    *out_r = __fsub_rn(__fmul_rn(zr, m_r), __fmul_rn(zi, m_i));
    *out_i = __fadd_rn(__fmul_rn(zr, m_i), __fmul_rn(zi, m_r));
  }
};

// The #8 reader: row `win` = b * S + s of a (B*S, n) block of windows that
// the caller already dechirped and windowed, rotated by
// e^{j(start[win] + rate[b]*i)} with the plain version's rounding; no
// scale and no multiplier.
struct RowReader {
  int S;
  const float* start;   // (B*S,) rotation phase of sample 0 of each row
  __host__ __device__ int rows() const { return S; }
  __device__ __forceinline__ Window operator()(
      const float* __restrict__ sr, const float* __restrict__ si,
      const int* __restrict__ t_off, const float* __restrict__ rate,
      const float* __restrict__ scale, int win, int n) const {
    const size_t base = (size_t)win * n;
    Window out;
    out.row_r = sr + base;
    out.row_i = si + base;
    out.stride = 1;
    out.rate = __ldg(rate + win / S);
    out.scale = 1.f;
    out.start = __ldg(start + win);
    return out;
  }
  __device__ __forceinline__ void sample(
      const Window& w, const float* __restrict__ mr,
      const float* __restrict__ mi, int i, float* out_r,
      float* out_i) const {
    const float zr = __ldg(w.row_r + i);
    const float zi = __ldg(w.row_i + i);
    const float ph = __fadd_rn(w.start, __fmul_rn(w.rate, (float)i));
    float sn, cs;
    sincosf(ph, &sn, &cs);
    *out_r = __fsub_rn(__fmul_rn(zr, cs), __fmul_rn(zi, sn));
    *out_i = __fadd_rn(__fmul_rn(zr, sn), __fmul_rn(zi, cs));
  }
};

// (d) the window's first-max bin, 20log10(sqrt(max)) - 20log10(n) and
// 20log10(sqrt(sum - max)) - 20log10(n).
__device__ __forceinline__ void store_detection(
    int win, float best, int bin, float sum, float scale_db,
    int* __restrict__ idx_out, float* __restrict__ pw_out,
    float* __restrict__ pav_out) {
  const float fund = sqrtf(best);
  const float noise = sqrtf(fmaxf(sum - best, 0.f));
  idx_out[win] = bin;
  pw_out[win] = 20.f * log10f(fund) - scale_db;
  pav_out[win] = 20.f * log10f(noise) - scale_db;
}

// Host launchers of the non-direct instances, defined beside their kernels
// (rx_dense.cu for n <= 512, rx_hybrid.cu for n = 1024 ... 16384) and
// called by the entry points rx_osr.cu, stream_scan.cu and
// rotate_detect.cu.  tw/bins are the FFT plan's float32 (K, 2) twiddles
// and int32 (n,) natural bins (ops/cuda_rx.py::_fft_plan, rx_fft.cuh).
// Each returns the cudaError_t of the launch.
#define LORA_RX_LAUNCHER(NAME, READER)                                       \
  int NAME(const float* sr, const float* si, const int* t_off,              \
           const float* rate, const float* scale, const float* mr,          \
           const float* mi, const float* tw, const int* bins, int B,        \
           const READER& rd, int n, float scale_db, int* idx, float* pw,    \
           float* pav, cudaStream_t stream)
LORA_RX_LAUNCHER(launch_dense_osr, OsrReader);
LORA_RX_LAUNCHER(launch_hybrid_osr, OsrReader);
LORA_RX_LAUNCHER(launch_dense_stream, StreamReader);
LORA_RX_LAUNCHER(launch_hybrid_stream, StreamReader);
LORA_RX_LAUNCHER(launch_dense_row, RowReader);

}  // namespace lora_rx
