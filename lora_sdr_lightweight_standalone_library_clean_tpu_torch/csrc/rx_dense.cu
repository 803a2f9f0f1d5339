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
//   (c) the n-point FFT (rx_fft.cuh), float32 throughout, with twiddles
//       from a host table built in float64 (the TPU multiplies by a dense
//       DFT matrix only because it has no FFT);
//   (d) |X|^2, the first maximum (lowest bin on ties, NaN counting as the
//       largest value, like torch.argmax and jnp.argmax), the sum, and
//       20log10(sqrt(max)) - 20log10(n), 20log10(sqrt(sum - max)) - 20log10(n).
//
// The design.  A window belongs to T = n/16 lanes of one warp (one lane
// for n <= 16), each lane holding 16 complex values in registers (all n of
// them for n <= 16): lane t loads samples t + q*T, q < 16, runs their
// 16-point DFT in registers (pass 0 of the plan), multiplies by the plan's
// twiddles, then log2(T) radix-2 passes pair lane t with lane t ^ h by
// __shfl_xor_sync, the data never leaving registers.  A warp holds 32/T
// windows and a block of 256 threads 8 warps; the kernel has no block
// barrier and no shared memory.  The first-max reduction reads each
// register's natural bin from the plan's `bins` table and runs over the
// window's T lanes by shuffles.
//
// What bounds it on the H100.  Each sample is read once from device memory
// (8 B of re/im) and each window writes 12 B, so the floor is the stream
// read, or at the stream scan's overlaps the 5 n log2 n float32 operations
// per window.  Per sample the kernel does one sincos where the reader
// rotates, a 16-point DFT in registers and log2(n/16) shuffled radix-2
// stages.  As built, the instruction issue bounds it: the StreamReader
// instance at 128 points runs about 1,735 instructions a thread, its warp
// holding four windows, and instructions x warps / (4 issue slots x 132
// SMs) comes to ~90 % of the measured time (PERF.md); each shuffled
// stage costs two shuffles, two adds and a complex product a value, the
// product wasted on the lower lane.  Steps (a), (b) and the dB epilogue of
// (d) live in rx_common.cuh, shared with rx_hybrid.cu (n = 1024 ...
// 16384).
#include <cuda_runtime.h>
#include <climits>

#include "rx_common.cuh"
#include "rx_fft.cuh"

namespace {

using lora_rx::brev;
using lora_rx::ilog2;
using lora_rx::takes;

template <int N>
struct DensePlan {
  static constexpr int kV = N < 16 ? N : 16;           // values per lane
  static constexpr int kLanes = N / kV;                 // lanes per window
  static constexpr int kThreads = 256;
  static constexpr int kWindows = kThreads / kLanes;    // per block
  static constexpr int kPasses = 1 + ilog2(kLanes);
};

// Radix-2 pass P >= 1 across the window's lanes: lane t pairs with t ^ H,
// H = lanes >> P; the lower lane keeps a + b, the upper one takes
// (a - b) * W_{2H}^{t mod H}, from the table at TABLE (none in the last
// pass, whose twiddle is 1).
template <int N, int P, int TABLE>
__device__ __forceinline__ void lane_pass(float2* x,
                                          const float2* __restrict__ tw,
                                          int t) {
  using Plan = DensePlan<N>;
  constexpr int H = Plan::kLanes >> P;
  constexpr bool kLast = P == Plan::kPasses - 1;
  const bool upper = (t & H) != 0;
  const float sgn = upper ? -1.f : 1.f;   // fma(sgn, own, other): a -/+ b
  float2 w = make_float2(1.f, 0.f);
  if constexpr (!kLast) {
    if (upper) w = __ldg(tw + TABLE + (t & (H - 1)));
  }
#pragma unroll
  for (int j = 0; j < Plan::kV; ++j) {
    const float ox = __shfl_xor_sync(0xffffffffu, x[j].x, H);
    const float oy = __shfl_xor_sync(0xffffffffu, x[j].y, H);
    const float2 d = make_float2(__fmaf_rn(sgn, x[j].x, ox),
                                 __fmaf_rn(sgn, x[j].y, oy));
    x[j] = kLast ? d : lora_rx::cmul(d, w);
  }
  if constexpr (!kLast) lane_pass<N, P + 1, TABLE + H>(x, tw, t);
}

template <int N, class Reader>
__global__ void __launch_bounds__(DensePlan<N>::kThreads)
rx_dense_kernel(const float* __restrict__ sr, const float* __restrict__ si,
                const int* __restrict__ t_off,
                const float* __restrict__ rate,
                const float* __restrict__ scale,
                const float* __restrict__ mr, const float* __restrict__ mi,
                const float2* __restrict__ tw,
                const int* __restrict__ bins, int n_windows, Reader rd,
                float scale_db, int* __restrict__ idx_out,
                float* __restrict__ pw_out, float* __restrict__ pav_out) {
  using Plan = DensePlan<N>;
  constexpr int T = Plan::kLanes;
  constexpr int V = Plan::kV;
  const int t = threadIdx.x % T;          // lane within the window
  const int win = blockIdx.x * Plan::kWindows + threadIdx.x / T;
  const bool valid = win < n_windows;

  // (a) + (b): load, normalise, rotate, multiply, in natural order.  Lanes
  // past the last window compute on zeros: every lane takes part in the
  // shuffles.
  float2 x[V];
  if (valid) {
    const lora_rx::Window w = rd(sr, si, t_off, rate, scale, win, N);
#pragma unroll
    for (int q = 0; q < V; ++q) {
      rd.sample(w, mr, mi, t + q * T, &x[q].x, &x[q].y);
    }
  } else {
#pragma unroll
    for (int q = 0; q < V; ++q) x[q] = make_float2(0.f, 0.f);
  }

  // (c) pass 0 in registers, then the radix-2 passes across lanes.
  lora_rx::dft_regs<V, 0>(x);
  if constexpr (Plan::kPasses > 1) {
#pragma unroll
    for (int j = 1; j < V; ++j) {
      x[j] = lora_rx::cmul(x[j], __ldg(tw + (brev(j, V) - 1) * T + t));
    }
    lane_pass<N, 1, (V - 1) * T>(x, tw, t);
  }

  // (d) |X|^2, first max (by natural bin) and sum: the lane's values, then
  // the window's lanes.
  float best = 0.f, sum = 0.f;
  int bk = 0;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float p = x[v].x * x[v].x + x[v].y * x[v].y;
    const int k = __ldg(bins + v * T + t);
    if (v == 0 || takes(p, k, best, bk)) {
      best = p;
      bk = k;
    }
    sum += p;
  }
#pragma unroll
  for (int off = T / 2; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best, off, T);
    const int ok = __shfl_down_sync(0xffffffffu, bk, off, T);
    const float os = __shfl_down_sync(0xffffffffu, sum, off, T);
    if (takes(ov, ok, best, bk)) {
      best = ov;
      bk = ok;
    }
    sum += os;
  }
  if (t == 0 && valid) {
    lora_rx::store_detection(win, best, bk, sum, scale_db, idx_out, pw_out,
                             pav_out);
  }
}

template <int N, class Reader>
int launch_rx(const float* sr, const float* si, const int* t_off,
              const float* rate, const float* scale, const float* mr,
              const float* mi, const float* tw, const int* bins, int B,
              const Reader& rd, float scale_db, int* idx, float* pw,
              float* pav, cudaStream_t stream) {
  using Plan = DensePlan<N>;
  const long long windows = (long long)B * rd.rows();
  if (windows == 0) return (int)cudaSuccess;
  if (windows > INT_MAX) return (int)cudaErrorInvalidValue;
  const long long blocks = (windows + Plan::kWindows - 1) / Plan::kWindows;
  rx_dense_kernel<N, Reader><<<(unsigned)blocks, Plan::kThreads, 0,
                               stream>>>(
      sr, si, t_off, rate, scale, mr, mi, (const float2*)tw, bins,
      (int)windows, rd, scale_db, idx, pw, pav);
  return (int)cudaGetLastError();
}

// n -> launch_rx<n, Reader>, or cudaErrorInvalidValue for a size this
// kernel does not take.
template <class Reader>
int dispatch(const float* sr, const float* si, const int* t_off,
             const float* rate, const float* scale, const float* mr,
             const float* mi, const float* tw, const int* bins, int B,
             const Reader& rd, int n, float scale_db, int* idx, float* pw,
             float* pav, cudaStream_t stream) {
#define LORA_RX_CASE(NN)                                                    \
  case NN:                                                                  \
    return launch_rx<NN, Reader>(sr, si, t_off, rate, scale, mr, mi, tw,    \
                                 bins, B, rd, scale_db, idx, pw, pav,       \
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
// (B,); mr/mi float32 (n,) multiplier; tw float32 (K, 2) FFT twiddles and
// bins int32 (n,) natural bins (ops/cuda_rx.py::_fft_plan); idx int32,
// pw/pav float32 (B, S) outputs.  Returns the cudaError_t of the launch.
extern "C" int lora_rx_dense(const void* sr, const void* si,
                             const void* t_off, const void* rate,
                             const void* scale, const void* mr,
                             const void* mi, const void* tw,
                             const void* bins, int B, int S, int n,
                             float scale_db, void* idx, void* pw, void* pav,
                             void* stream) {
  if (B < 0 || S <= 0) return (int)cudaErrorInvalidValue;
  return dispatch((const float*)sr, (const float*)si, (const int*)t_off,
                  (const float*)rate, (const float*)scale, (const float*)mr,
                  (const float*)mi, (const float*)tw, (const int*)bins, B,
                  lora_rx::DirectReader{S}, n, scale_db, (int*)idx,
                  (float*)pw, (float*)pav, (cudaStream_t)stream);
}

// The reader instances that rx_osr.cu, stream_scan.cu and rotate_detect.cu
// launch (rx_common.cuh).
namespace lora_rx {

LORA_RX_LAUNCHER(launch_dense_osr, OsrReader) {
  return dispatch(sr, si, t_off, rate, scale, mr, mi, tw, bins, B, rd, n,
                  scale_db, idx, pw, pav, stream);
}

LORA_RX_LAUNCHER(launch_dense_stream, StreamReader) {
  return dispatch(sr, si, t_off, rate, scale, mr, mi, tw, bins, B, rd, n,
                  scale_db, idx, pw, pav, stream);
}

LORA_RX_LAUNCHER(launch_dense_row, RowReader) {
  return dispatch(sr, si, t_off, rate, scale, mr, mi, tw, bins, B, rd, n,
                  scale_db, idx, pw, pav, stream);
}

}  // namespace lora_rx
