// Streaming scan (kernel #7) for Hopper (sm_90a): the entry point of the
// StreamReader instances of rx_dense.cu (n <= 512) and rx_hybrid.cu
// (n = 1024 ... 4096).
//
// Replaces the JAX package's TPU kernel
//   ops/pallas_stream.py:_stream_kernel (called through _stream_call /
//   stream_window_detect), which parallel/streaming.py::_scan_block runs
//   over every stride-aligned window of a continuous stream.
//
// What it computes, per stream b and window w (W windows per stream):
//   (a) the n samples x[i] = ext[b, w*stride + i*osr], zero past the end of
//       the stream (the plain version pads with zeros; the caller's
//       one-symbol halo of zeros is this padding);
//   (b) z[i] = x[i] * dc[i], dc the scan down-chirp (the full-rate base
//       down-chirp at the phase-0 decimation points), each product rounded
//       as the plain PyTorch version rounds it; no rotation, so no sincos;
//   (c) the n-point FFT of rx_fft.cuh and |X|^2;
//   (d) the first-max bin, 20log10(sqrt(max)) - 20log10(n) and
//       20log10(sqrt(sum - max)) - 20log10(n), in window order.
// The TPU kernel builds its step/stride window phases by rolling lanes of a
// VMEM slab and stacks them into MXU tiles, and decimates the stream first
// when osr > 1; here each window is one RX window whose threads read their
// samples straight from device memory with stride osr.
//
// What bounds it on the H100.  Each sample is read once from device memory
// (8 B) and each window writes 12 B; at stride step/4 each sample lies in
// 4 windows (8 at the wide default, stride step/8), and L2 carries that
// overlap.  The FFT work grows with the overlap (5 n log2 n float32
// operations per window), so at the default strides the float32 operations
// (67 TFLOP/s), not the bytes, give the larger bound.  The design keeps
// windows and spectra out of device memory, as the RX kernels do, and runs
// their FFT: registers and shuffles to n = 512, registers and two
// conflict-free shared-memory exchanges at 1024 ... 4096.
#include <cuda_runtime.h>

#include "rx_common.cuh"

// sr/si: float32 (B, len) streams; mr/mi float32 (n,) scan down-chirp;
// tw float32 (K, 2) FFT twiddles and bins int32 (n,) natural
// bins (ops/cuda_rx.py::_fft_plan); W windows per stream, starting
// every `stride` samples, each reading n samples every `osr`; idx int32,
// pw/pav float32 (B, W) outputs.  Returns the cudaError_t of the launch.
extern "C" int lora_stream_scan(const void* sr, const void* si,
                                const void* mr, const void* mi,
                                const void* tw, const void* bins, int B,
                                long long len, int W, int stride, int n,
                                int osr, float scale_db, void* idx, void* pw,
                                void* pav, void* stream) {
  if (B < 0 || len < 0 || W <= 0 || stride < 1 || osr < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const lora_rx::StreamReader rd{len, W, stride, osr};
  auto launch = n <= 512 ? lora_rx::launch_dense_stream
                         : lora_rx::launch_hybrid_stream;
  return launch((const float*)sr, (const float*)si, nullptr, nullptr,
                nullptr, (const float*)mr, (const float*)mi,
                (const float*)tw, (const int*)bins, B, rd, n, scale_db,
                (int*)idx, (float*)pw, (float*)pav, (cudaStream_t)stream);
}
