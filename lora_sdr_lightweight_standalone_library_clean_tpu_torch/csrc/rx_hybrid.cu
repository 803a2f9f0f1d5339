// Fused packet RX for large windows (n = 1024 ... 16384) for Hopper
// (sm_90a).
//
// Replaces the JAX package's TPU kernel
//   ops/pallas_rx.py:_rx_kernel (called through _rx_call /
//   rx_window_detect) in its osr == 1 direct-window form with the hybrid
//   branch of _dft_mag_argmax (_hybrid_consts, _slice_tw_consts) and the
//   dB epilogue of _ablated_detect: n = 1024 ... 4096 for the decimated
//   receivers, n = 8192 and 16384 for the wide receiver, whose
//   (n*osr)-point detection is this form with n = step
//   (rx_window_detect(wide=True), ops/pallas_rx.py:831-834).  Its
//   OsrReader instances (rx_common.cuh, launched by rx_osr.cu) are the
//   decimated osr > 1 and halo windows of the same kernel; its
//   StreamReader instance is the streaming scan at n = 1024 ... 4096
//   (ops/pallas_stream.py:_stream_kernel, launched by stream_scan.cu).
//
// What it computes, per (packet b, symbol s) window of n samples: steps
// (a)-(d) of rx_dense.cu (rx_common.cuh holds the shared pieces): the
// timing-shifted window with the reference's edge clamp, the
// scale x rotation x multiplier product rounded as the plain PyTorch
// version rounds it, an n-point DFT, and the first-max bin in natural
// order (lowest index on ties) with its power and noise dB.  The TPU forms
// the DFT as log2(n/128) DIF passes plus a 128-point DFT matmul because it
// has no FFT; none of that is carried over.
//
// The FFT (rx_fft.cuh).  One block of n/16 threads holds one window, and
// each thread holds 16 complex values in registers.  Thread t loads
// samples t + q*n/16, q < 16 (coalesced), and the transform runs as
// radix-16 passes plus one radix-2/4/8 pass where log2(n) is not a multiple
// of 4: 16*16*4 at 1024, 16*16*8 at 2048, 16^3 at 4096, 16^3*2 at 8192,
// 16^3*4 at 16384.  Each pass is a 16-point DFT in registers (a radix-r
// pass does 16/r r-point DFTs), its inter-pass twiddles from the plan's
// table through __ldg, then one exchange through shared memory and one
// __syncthreads(): 2 exchanges at 1024 ... 4096, 3 at 8192 and 16384, in
// place of log2(n) barrier-separated radix-2 stages.  The last pass does
// not store: its values go straight into the first-max reduction, each
// with its natural bin from the plan's `bins` table.
//
// Why the exchanges are free of bank conflicts.  The plane holds float2
// (re, im) words, word a at a + a/16 (one word of padding per 16), so in
// bank pair (a + a/16) mod 16.  A 64-bit shared access is served per
// half-warp, 16 lanes over the 16 bank pairs.  In every pass the lanes of
// a half-warp hold 16 consecutive butterflies b, and for each q butterfly
// b touches c*L_p + q*L_{p+1} + m (c = b / L_{p+1}, m = b mod L_{p+1}).
// Where L_{p+1} >= 16 the 16 lanes touch 16 consecutive words of one
// 16-aligned run: 16 pairs.  Where L_{p+1} < 16 they form 16 / L_{p+1}
// runs of L_{p+1} consecutive words, L_p words apart; unpadded these
// would share pairs (16-way at 4096's last pass, where L_p = 16), and the
// a/16 term moves each run onto pairs of its own.  Stores use the same
// addresses as the loads of their pass.  tests/test_torch_fft_plan.py
// enumerates every load and store of every plan and finds 16 distinct
// pairs in each half-warp (and up to 16-way conflicts without the pad).
//
// What bounds it on the H100.  Per window the stream read (8 B a sample)
// and 5 n log2 n float32 operations; shared memory carries 2-3 exchanges of
// 8 B a sample each way, and the twiddle and bin tables come from L1.  At
// 16384 one block of 1024 threads and 136 KB of shared memory fills an SM.
// As built, the instruction issue bounds it: about 1,930 instructions a
// thread at 4096 (the StreamReader instance), a quarter of them the DFTs'
// adds and the rest twiddle products, sample and table addressing and the
// first-max compares; instructions x warps / (4 issue slots x 132 SMs)
// comes to ~90 % of the measured time (PERF.md).
#include <cuda_runtime.h>
#include <climits>

#include "rx_common.cuh"
#include "rx_fft.cuh"

namespace {

using lora_rx::brev;
using lora_rx::ilog2;
using lora_rx::takes;

template <int N>
struct HybridPlan {
  static constexpr int kV = 16;                       // values per thread
  static constexpr int kThreads = N / kV;             // one window
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kFull = ilog2(N) / 4;          // radix-16 passes
  static constexpr int kRem = N >> (4 * kFull);       // last radix, or 1
  static constexpr int kPasses = kFull + (kRem > 1 ? 1 : 0);
  static constexpr int kWords = N + N / 16;           // padded float2 words
  // Blocks an SM must hold: 1024 threads' worth caps ptxas at 64 registers
  // a thread, which fits without spilling and, with the padded plane
  // (8.5 KB at 1024, 35 KB at 4096), keeps 4-16 blocks resident: 29 % less
  // time at 4096 than with a bound of one block, under which ptxas takes
  // 120 registers (H100, PERF.md).  At 8192 64 registers spill, so one
  // block, with up to 128.
  static constexpr int kMinBlocks = N == 8192 ? 1 : 1024 / kThreads;
  __host__ __device__ static constexpr int radix(int p) {
    return p < kFull ? 16 : kRem;
  }
  // L_p: the points of each sub-transform pass p works on
  __host__ __device__ static constexpr int span(int p) {
    return p == 0 ? N : span(p - 1) / radix(p - 1);
  }
  // offset of pass p's twiddles in the table, in (re, im) pairs
  __host__ __device__ static constexpr int table(int p) {
    return p == 0 ? 0 : table(p - 1) + (radix(p - 1) - 1) * span(p);
  }
};

__device__ __forceinline__ int padded(int a) { return a + (a >> 4); }

// Butterfly b = t + G * threads of pass P, on registers x[G*R ... G*R+R-1]
// of thread t, then the thread's next butterfly of the pass.
template <int N, int P, int G = 0>
__device__ __forceinline__ void hybrid_fly(float2* x, float2* sh,
                                           const float2* __restrict__ tw,
                                           int t) {
  using Plan = HybridPlan<N>;
  constexpr int R = Plan::radix(P);
  constexpr int L = Plan::span(P);
  constexpr int Lq = L / R;
  constexpr int O = G * R;
  const int b = t + G * Plan::kThreads;
  const int m = b % Lq;
  const int base = (b / Lq) * L + m;
  if constexpr (P > 0) {
#pragma unroll
    for (int q = 0; q < R; ++q) x[O + q] = sh[padded(base + q * Lq)];
  }
  lora_rx::dft_regs<R, O>(x);
  if constexpr (P + 1 < Plan::kPasses) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int s = brev(j, R);
      if (s > 0) {
        x[O + j] = lora_rx::cmul(
            x[O + j], __ldg(tw + Plan::table(P) + (s - 1) * Lq + m));
      }
      sh[padded(base + s * Lq)] = x[O + j];
    }
  }
  if constexpr (G + 1 < Plan::kV / R) hybrid_fly<N, P, G + 1>(x, sh, tw, t);
}

// Pass P and the passes after it; one barrier between two passes.
template <int N, int P>
__device__ __forceinline__ void hybrid_pass(float2* x, float2* sh,
                                            const float2* __restrict__ tw,
                                            int t) {
  hybrid_fly<N, P>(x, sh, tw, t);
  if constexpr (P + 1 < HybridPlan<N>::kPasses) {
    __syncthreads();
    hybrid_pass<N, P + 1>(x, sh, tw, t);
  }
}

template <int N, class Reader>
__global__ void __launch_bounds__(HybridPlan<N>::kThreads,
                                  HybridPlan<N>::kMinBlocks)
rx_hybrid_kernel(const float* __restrict__ sr, const float* __restrict__ si,
                 const int* __restrict__ t_off,
                 const float* __restrict__ rate,
                 const float* __restrict__ scale,
                 const float* __restrict__ mr, const float* __restrict__ mi,
                 const float2* __restrict__ tw,
                 const int* __restrict__ bins, Reader rd, float scale_db,
                 int* __restrict__ idx_out, float* __restrict__ pw_out,
                 float* __restrict__ pav_out) {
  using Plan = HybridPlan<N>;
  constexpr int T = Plan::kThreads;
  extern __shared__ float2 planes[];
  __shared__ float red_v[Plan::kWarps];
  __shared__ int red_k[Plan::kWarps];
  __shared__ float red_s[Plan::kWarps];

  const int win = blockIdx.x;
  const int t = threadIdx.x;

  // (a) + (b): load, normalise, rotate, multiply, in natural order.
  float2 x[Plan::kV];
  const lora_rx::Window w = rd(sr, si, t_off, rate, scale, win, N);
#pragma unroll
  for (int q = 0; q < Plan::kV; ++q) {
    rd.sample(w, mr, mi, t + q * T, &x[q].x, &x[q].y);
  }

  // (c) the FFT; output in digit-reversed order, in registers.
  hybrid_pass<N, 0>(x, planes, tw, t);

  // (d) |X|^2, first max (by natural bin) and sum: the thread's 16 bins,
  // then the warp, then the warps in order.
  float best = 0.f, sum = 0.f;
  int bk = 0;
#pragma unroll
  for (int v = 0; v < Plan::kV; ++v) {
    const float p = x[v].x * x[v].x + x[v].y * x[v].y;
    const int k = __ldg(bins + v * T + t);
    if (v == 0 || takes(p, k, best, bk)) {
      best = p;
      bk = k;
    }
    sum += p;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best, off);
    const int ok = __shfl_down_sync(0xffffffffu, bk, off);
    const float os = __shfl_down_sync(0xffffffffu, sum, off);
    if (takes(ov, ok, best, bk)) {
      best = ov;
      bk = ok;
    }
    sum += os;
  }
  if ((t & 31) == 0) {
    red_v[t / 32] = best;
    red_k[t / 32] = bk;
    red_s[t / 32] = sum;
  }
  __syncthreads();
  if (t == 0) {
    float bv = red_v[0];
    int kk = red_k[0];
    float tot = red_s[0];
#pragma unroll
    for (int q = 1; q < Plan::kWarps; ++q) {
      if (takes(red_v[q], red_k[q], bv, kk)) {
        bv = red_v[q];
        kk = red_k[q];
      }
      tot += red_s[q];
    }
    lora_rx::store_detection(win, bv, kk, tot, scale_db, idx_out, pw_out,
                             pav_out);
  }
}

template <int N, class Reader>
int launch_rx(const float* sr, const float* si, const int* t_off,
              const float* rate, const float* scale, const float* mr,
              const float* mi, const float* tw, const int* bins, int B,
              const Reader& rd, float scale_db, int* idx, float* pw,
              float* pav, cudaStream_t stream) {
  using Plan = HybridPlan<N>;
  const long long windows = (long long)B * rd.rows();
  if (windows == 0) return (int)cudaSuccess;
  if (windows > INT_MAX) return (int)cudaErrorInvalidValue;
  const size_t smem = Plan::kWords * sizeof(float2);
  if (smem > 48 * 1024) {
    // above 48 KB a launch is refused unless the kernel opted in first
    const cudaError_t e = cudaFuncSetAttribute(
        rx_hybrid_kernel<N, Reader>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  rx_hybrid_kernel<N, Reader><<<(unsigned)windows, Plan::kThreads, smem,
                                stream>>>(
      sr, si, t_off, rate, scale, mr, mi, (const float2*)tw, bins, rd,
      scale_db, idx, pw, pav);
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
    LORA_RX_CASE(1024)
    LORA_RX_CASE(2048)
    LORA_RX_CASE(4096)
    LORA_RX_CASE(8192)
    LORA_RX_CASE(16384)
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
extern "C" int lora_rx_hybrid(const void* sr, const void* si,
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

// The reader instances that rx_osr.cu and stream_scan.cu launch
// (rx_common.cuh).
namespace lora_rx {

LORA_RX_LAUNCHER(launch_hybrid_osr, OsrReader) {
  return dispatch(sr, si, t_off, rate, scale, mr, mi, tw, bins, B, rd, n,
                  scale_db, idx, pw, pav, stream);
}

LORA_RX_LAUNCHER(launch_hybrid_stream, StreamReader) {
  return dispatch(sr, si, t_off, rate, scale, mr, mi, tw, bins, B, rd, n,
                  scale_db, idx, pw, pav, stream);
}

}  // namespace lora_rx
