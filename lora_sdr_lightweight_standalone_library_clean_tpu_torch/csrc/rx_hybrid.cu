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
// the DFT as log2(n/128) DIF passes plus a 128-point DFT matmul and maps
// bins back through a bit-reversed `nat` table, because it has no FFT;
// none of that is carried over.  Here the DFT is the same radix-2
// decimation-in-time FFT as rx_dense.cu, in float32 with float64-built
// twiddles, so bins come out in natural order.
//
// How it differs from rx_dense.cu.  A window no longer fits one butterfly
// per thread: n/2 = 2048 threads would exceed the 1024-thread block limit.
// So one block of 512 threads holds one window and each thread takes
// n/1024 butterflies per stage and n/512 samples on load and in the
// reduction.  The two planes live in dynamic shared memory, 2 x n x 4 B =
// 8/16/32 KB per block, under the 48 KB a launch may take without
// cudaFuncSetAttribute; 8192/16384 (64/128 KB) set that attribute before
// their launch, and at 16384 one block fits an SM (512 threads).
//
// What bounds it on the H100.  The floor is the one read of the stream,
// 8 B per sample (554 MB for 256 sf12 packets of 66 symbols, about
// 0.17 ms at 3.35 TB/s); each window writes 12 B.  This simple design sits
// instead on its log2(n) = 10-14 barrier-separated shared-memory stages
// and the accurate sincosf per sample; making it fast is later work.
#include <cuda_runtime.h>
#include <climits>

#include "rx_common.cuh"

namespace {

using lora_rx::takes;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

template <int N, class Reader>
__global__ void __launch_bounds__(kThreads)
rx_hybrid_kernel(const float* __restrict__ sr, const float* __restrict__ si,
                 const int* __restrict__ t_off,
                 const float* __restrict__ rate,
                 const float* __restrict__ scale,
                 const float* __restrict__ mr, const float* __restrict__ mi,
                 const float* __restrict__ twr,
                 const float* __restrict__ twi, Reader rd, float scale_db,
                 int* __restrict__ idx_out, float* __restrict__ pw_out,
                 float* __restrict__ pav_out) {
  constexpr int kSamples = N / kThreads;        // samples per thread
  constexpr int kFlies = N / 2 / kThreads;      // butterflies per stage
  constexpr int kLog = lora_rx::ilog2(N);
  extern __shared__ float planes[];
  float* wr = planes;
  float* wi = planes + N;
  __shared__ float red_v[kWarps];
  __shared__ int red_k[kWarps];
  __shared__ float red_s[kWarps];

  const int win = blockIdx.x;
  const int lt = threadIdx.x;

  // (a) + (b): load, normalise, rotate, multiply; store bit-reversed for
  // the decimation-in-time FFT below.
  const lora_rx::Window w = rd(sr, si, t_off, rate, scale, win, N);
#pragma unroll
  for (int h = 0; h < kSamples; ++h) {
    const int i = lt + h * kThreads;
    const int j = (int)(__brev((unsigned)i) >> (32 - kLog));
    rd.sample(w, mr, mi, i, &wr[j], &wi[j]);
  }
  __syncthreads();

  // (c) radix-2 decimation-in-time FFT: kFlies butterflies per thread per
  // stage, twiddle W^k = twr[k] + j*twi[k] = exp(-2j*pi*k/N).
#pragma unroll
  for (int len = 2; len <= N; len <<= 1) {
    const int half = len >> 1;
#pragma unroll
    for (int f = 0; f < kFlies; ++f) {
      const int fly = lt + f * kThreads;
      const int pos = fly & (half - 1);
      const int i0 = (fly / half) * len + pos;
      const int i1 = i0 + half;
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

  // (d) |X|^2, first max and sum: kSamples bins per thread in increasing
  // order, then the warp, then the warps in order.
  float best = 0.f, sum = 0.f;
  int bk = lt;
#pragma unroll
  for (int h = 0; h < kSamples; ++h) {
    const int k = lt + h * kThreads;
    const float v = wr[k] * wr[k] + wi[k] * wi[k];
    if (h == 0 || takes(v, k, best, bk)) {
      best = v;
      bk = k;
    }
    sum += v;
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
  if ((lt & 31) == 0) {
    red_v[lt / 32] = best;
    red_k[lt / 32] = bk;
    red_s[lt / 32] = sum;
  }
  __syncthreads();
  if (lt == 0) {
    float bv = red_v[0];
    int kk = red_k[0];
    float tot = red_s[0];
#pragma unroll
    for (int q = 1; q < kWarps; ++q) {
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
              const float* mi, const float* twr, const float* twi, int B,
              const Reader& rd, float scale_db, int* idx, float* pw,
              float* pav, cudaStream_t stream) {
  const long long windows = (long long)B * rd.rows();
  if (windows == 0) return (int)cudaSuccess;
  if (windows > INT_MAX) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * N * sizeof(float);
  if (smem > 48 * 1024) {
    // above 48 KB a launch is refused unless the kernel opted in first
    const cudaError_t e = cudaFuncSetAttribute(
        rx_hybrid_kernel<N, Reader>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  rx_hybrid_kernel<N, Reader><<<(unsigned)windows, kThreads, smem, stream>>>(
      sr, si, t_off, rate, scale, mr, mi, twr, twi, rd, scale_db, idx, pw,
      pav);
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
// (B,); mr/mi float32 (n,) multiplier; twr/twi float32 (n/2,) FFT
// twiddles; idx int32, pw/pav float32 (B, S) outputs.  Returns the
// cudaError_t of the launch.
extern "C" int lora_rx_hybrid(const void* sr, const void* si,
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

// The reader instances that rx_osr.cu and stream_scan.cu launch
// (rx_common.cuh).
namespace lora_rx {

LORA_RX_LAUNCHER(launch_hybrid_osr, OsrReader) {
  return dispatch(sr, si, t_off, rate, scale, mr, mi, twr, twi, B, rd, n,
                  scale_db, idx, pw, pav, stream);
}

LORA_RX_LAUNCHER(launch_hybrid_stream, StreamReader) {
  return dispatch(sr, si, t_off, rate, scale, mr, mi, twr, twi, B, rd, n,
                  scale_db, idx, pw, pav, stream);
}

}  // namespace lora_rx
