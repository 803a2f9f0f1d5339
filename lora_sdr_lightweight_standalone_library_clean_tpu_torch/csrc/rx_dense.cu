// Fused packet RX (n = 4 ... 512) for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernel
//   ops/pallas_rx.py:_rx_kernel (called through _rx_call /
//   rx_window_detect) in its osr == 1 direct-window form
//   (_shifted_windows_direct), with the dense branch of _dft_mag_argmax and
//   the dB epilogue of _ablated_detect.  Its OsrReader instances
//   (rx_common.cuh, launched by rx_osr.cu) are the decimated osr > 1 and
//   halo windows of the same kernel (padded/slab form, _shifted_windows);
//   its StreamReader and RowReader instances are the streaming scan
//   (ops/pallas_stream.py:_stream_kernel, launched by stream_scan.cu) and
//   the rotate-detect kernel (ops/pallas_detect.py:_detect_kernel,
//   launched by rotate_detect.cu) at n <= 512.
//
// What it computes, per (packet b, symbol s) window of n samples:
//   (a) the timing-shifted window x[i] = stream[b, s*n + t + i], with the
//       reference's edge clamp (phy.cpp:209-216): symbol 0 reads unshifted
//       when t < 0, symbol S-1 when t > 0;
//   (b) z[i] = x[i] * scale[b] * e^{j(start + rate[b]*i)} * mult[i], with
//       start = rate[b] * (s*n + t), each product rounded as the plain
//       PyTorch version rounds it (no contraction into FMAs);
//   (c) an n-point radix-2 FFT in shared memory, float32 throughout, with
//       twiddles from a host table built in float64 (the TPU multiplies by
//       a dense DFT matrix only because it has no FFT);
//   (d) |X|^2, the first maximum (lowest bin on ties, NaN counting as the
//       largest value, like torch.argmax and jnp.argmax), the sum, and
//       20log10(sqrt(max)) - 20log10(n), 20log10(sqrt(sum - max)) - 20log10(n).
//
// What bounds it on the H100.  Each sample is read once from device memory
// (8 B of re/im) and each window writes 12 B, so the floor is the stream
// read.  The work per sample is one sincos, a few multiplies and log2(n)
// shared-memory butterfly stages, each behind a block barrier.  The design
// keeps every intermediate in shared memory and registers: the windows and
// the spectrum never touch device memory.  One block holds one window of
// n/2 threads (one butterfly per thread per stage), or 128 / (n/2) windows
// when n < 256, so every block has at least 128 threads.  When a window has
// fewer than 32 threads (n <= 32), the warp reduction runs in segments of
// n/2 lanes, so it never mixes two windows.  Steps (a), (b) and the dB
// epilogue of (d) live in rx_common.cuh, shared with rx_hybrid.cu (n =
// 1024 ... 16384).
#include <cuda_runtime.h>
#include <climits>

#include "rx_common.cuh"

namespace {

using lora_rx::ilog2;
using lora_rx::takes;

template <int N>
struct RxShape {
  static constexpr int kHalf = N / 2;                    // threads / window
  static constexpr int kWindows = kHalf >= 128 ? 1 : 128 / kHalf;
  static constexpr int kThreads = kWindows * kHalf;
  static constexpr int kSeg = kHalf < 32 ? kHalf : 32;  // lanes / reduction
  static constexpr int kWarps = kHalf / kSeg;            // segments / window
  static constexpr int kLog = ilog2(N);
};

template <int N, class Reader>
__global__ void __launch_bounds__(RxShape<N>::kThreads)
rx_dense_kernel(const float* __restrict__ sr, const float* __restrict__ si,
                const int* __restrict__ t_off,
                const float* __restrict__ rate,
                const float* __restrict__ scale,
                const float* __restrict__ mr, const float* __restrict__ mi,
                const float* __restrict__ twr,
                const float* __restrict__ twi, int n_windows, Reader rd,
                float scale_db, int* __restrict__ idx_out,
                float* __restrict__ pw_out, float* __restrict__ pav_out) {
  using Shape = RxShape<N>;
  constexpr int H = Shape::kHalf;
  __shared__ float xr[Shape::kWindows][N];
  __shared__ float xi[Shape::kWindows][N];
  __shared__ float red_v[Shape::kWindows][Shape::kWarps];
  __shared__ int red_k[Shape::kWindows][Shape::kWarps];
  __shared__ float red_s[Shape::kWindows][Shape::kWarps];

  const int wl = threadIdx.x / H;        // window within the block
  const int lt = threadIdx.x % H;        // thread within the window
  const int win = blockIdx.x * Shape::kWindows + wl;
  const bool valid = win < n_windows;
  float* wr = xr[wl];
  float* wi = xi[wl];

  // (a) + (b): load, normalise, rotate, multiply; store bit-reversed for
  // the decimation-in-time FFT below.
  if (valid) {
    const lora_rx::Window w = rd(sr, si, t_off, rate, scale, win, N);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = lt + h * H;
      const int j = (int)(__brev((unsigned)i) >> (32 - Shape::kLog));
      rd.sample(w, mr, mi, i, &wr[j], &wi[j]);
    }
  }
  __syncthreads();

  // (c) radix-2 decimation-in-time FFT: one butterfly per thread per stage,
  // twiddle W^k = twr[k] + j*twi[k] = exp(-2j*pi*k/N).
#pragma unroll
  for (int len = 2; len <= N; len <<= 1) {
    const int half = len >> 1;
    const int pos = lt & (half - 1);
    const int i0 = (lt / half) * len + pos;
    const int i1 = i0 + half;
    if (valid) {
      const int k = pos * (N / len);
      const float c = __ldg(twr + k);
      const float sn = __ldg(twi + k);
      const float br = wr[i1], bi = wi[i1];
      const float tr = br * c - bi * sn;
      const float ti = br * sn + bi * c;
      const float ar = wr[i0], ai = wi[i0];
      wr[i0] = ar + tr;
      wi[i0] = ai + ti;
      wr[i1] = ar - tr;
      wi[i1] = ai - ti;
    }
    __syncthreads();
  }

  // (d) |X|^2, first max and sum: two bins per thread, then the warp (or
  // the window's segment of it), then the warps of the window in order.
  float best = 0.f, sum = 0.f;
  int bk = lt;
  if (valid) {
    const float v0 = wr[lt] * wr[lt] + wi[lt] * wi[lt];
    const float v1 = wr[lt + H] * wr[lt + H] + wi[lt + H] * wi[lt + H];
    best = v0;
    if (takes(v1, lt + H, v0, lt)) {
      best = v1;
      bk = lt + H;
    }
    sum = v0 + v1;
  }
#pragma unroll
  for (int off = Shape::kSeg / 2; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best, off, Shape::kSeg);
    const int ok = __shfl_down_sync(0xffffffffu, bk, off, Shape::kSeg);
    const float os = __shfl_down_sync(0xffffffffu, sum, off, Shape::kSeg);
    if (takes(ov, ok, best, bk)) {
      best = ov;
      bk = ok;
    }
    sum += os;
  }
  if ((lt & (Shape::kSeg - 1)) == 0) {
    red_v[wl][lt / Shape::kSeg] = best;
    red_k[wl][lt / Shape::kSeg] = bk;
    red_s[wl][lt / Shape::kSeg] = sum;
  }
  __syncthreads();
  if (lt == 0 && valid) {
    float bv = red_v[wl][0];
    int kk = red_k[wl][0];
    float tot = red_s[wl][0];
#pragma unroll
    for (int w = 1; w < Shape::kWarps; ++w) {
      if (takes(red_v[wl][w], red_k[wl][w], bv, kk)) {
        bv = red_v[wl][w];
        kk = red_k[wl][w];
      }
      tot += red_s[wl][w];
    }
    lora_rx::store_detection(win, bv, kk, tot, scale_db, idx_out, pw_out,
                             pav_out);
  }
}

template <int N, class Reader>
int launch_rx(const float* sr, const float* si, const int* t_off,
              const float* rate, const float* scale, const float* mr,
              const float* mi, const float* twr, const float* twi, int B,
              const Reader& rd, float scale_db, int* idx, float* pw,
              float* pav, cudaStream_t stream) {
  using Shape = RxShape<N>;
  const long long windows = (long long)B * rd.rows();
  if (windows == 0) return (int)cudaSuccess;
  if (windows > INT_MAX) return (int)cudaErrorInvalidValue;
  const long long blocks =
      (windows + Shape::kWindows - 1) / Shape::kWindows;
  rx_dense_kernel<N, Reader><<<(unsigned)blocks, Shape::kThreads, 0,
                               stream>>>(
      sr, si, t_off, rate, scale, mr, mi, twr, twi, (int)windows, rd,
      scale_db, idx, pw, pav);
  return (int)cudaGetLastError();
}

// n -> launch_rx<n, Reader>, or cudaErrorInvalidValue for a size this
// kernel does not take.
template <class Reader>
int dispatch(const float* sr, const float* si, const int* t_off,
             const float* rate, const float* scale, const float* mr,
             const float* mi, const float* twr, const float* twi, int B,
             const Reader& rd, int n, float scale_db, int* idx, float* pw,
             float* pav, cudaStream_t stream) {
#define LORA_RX_CASE(NN)                                                    \
  case NN:                                                                  \
    return launch_rx<NN, Reader>(sr, si, t_off, rate, scale, mr, mi, twr,   \
                                 twi, B, rd, scale_db, idx, pw, pav,        \
                                 stream);
  switch (n) {
    LORA_RX_CASE(4)
    LORA_RX_CASE(8)
    LORA_RX_CASE(16)
    LORA_RX_CASE(32)
    LORA_RX_CASE(64)
    LORA_RX_CASE(128)
    LORA_RX_CASE(256)
    LORA_RX_CASE(512)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LORA_RX_CASE
}

}  // namespace

// sr/si: float32 (B, S*n) streams; t_off int32 (B,), rate/scale float32
// (B,); mr/mi float32 (n,) multiplier; twr/twi float32 (n/2,) FFT
// twiddles; idx int32, pw/pav float32 (B, S) outputs.  Returns the
// cudaError_t of the launch.
extern "C" int lora_rx_dense(const void* sr, const void* si,
                             const void* t_off, const void* rate,
                             const void* scale, const void* mr,
                             const void* mi, const void* twr,
                             const void* twi, int B, int S, int n,
                             float scale_db, void* idx, void* pw, void* pav,
                             void* stream) {
  if (B < 0 || S <= 0) return (int)cudaErrorInvalidValue;
  return dispatch((const float*)sr, (const float*)si, (const int*)t_off,
                  (const float*)rate, (const float*)scale, (const float*)mr,
                  (const float*)mi, (const float*)twr, (const float*)twi, B,
                  lora_rx::DirectReader{S}, n, scale_db, (int*)idx,
                  (float*)pw, (float*)pav, (cudaStream_t)stream);
}

// The reader instances that rx_osr.cu, stream_scan.cu and rotate_detect.cu
// launch (rx_common.cuh).
namespace lora_rx {

LORA_RX_LAUNCHER(launch_dense_osr, OsrReader) {
  return dispatch(sr, si, t_off, rate, scale, mr, mi, twr, twi, B, rd, n,
                  scale_db, idx, pw, pav, stream);
}

LORA_RX_LAUNCHER(launch_dense_stream, StreamReader) {
  return dispatch(sr, si, t_off, rate, scale, mr, mi, twr, twi, B, rd, n,
                  scale_db, idx, pw, pav, stream);
}

LORA_RX_LAUNCHER(launch_dense_row, RowReader) {
  return dispatch(sr, si, t_off, rate, scale, mr, mi, twr, twi, B, rd, n,
                  scale_db, idx, pw, pav, stream);
}

}  // namespace lora_rx
