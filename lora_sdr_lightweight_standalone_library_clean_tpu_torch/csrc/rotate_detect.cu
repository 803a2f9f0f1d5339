// Rotate-detect (kernel #8) for Hopper (sm_90a): the entry point of the
// RowReader instance of rx_dense.cu (n = 4 ... 512).
//
// Replaces the JAX package's TPU kernel
//   ops/pallas_detect.py:_detect_kernel (called through
//   fused_rotate_detect), the second stage of the two-stage detect route
//   (models/tones.py::_rotate_detect, backend="pallas").
//
// What it computes, per row r = b*S + s of the (B*S, n) windows that the
// caller already timing-shifted, dechirped and windowed:
//   (a) the row's n samples z[i];
//   (b) z[i] * e^{j(start[r] + rate[b]*i)}, each product rounded as the
//       plain PyTorch version rounds it, with the accurate sincosf;
//   (c) the n-point FFT of rx_fft.cuh and |X|^2;
//   (d) the first-max bin, 20log10(sqrt(max)) - 20log10(n) and
//       20log10(sqrt(sum - max)) - 20log10(n).
// The TPU kernel multiplies each tile of rows by dense (n, n) cos and sin
// DFT matrices on its MXU, because it has no FFT; none of that is carried
// over.
//
// What bounds it on the H100.  The rows are read once (8 B a sample) and
// each writes 12 B; per sample one sincos, the rotation and the FFT in
// registers and shuffles.  The kernel is rx_dense.cu's with a window
// reader that reads rows instead of a timing-shifted stream.
#include <cuda_runtime.h>

#include "rx_common.cuh"

// zr/zi: float32 (B, S, n) windows; rate float32 (B,); start float32
// (B, S); tw float32 (K, 2) FFT twiddles and bins int32 (n,) natural
// bins (ops/cuda_rx.py::_fft_plan); idx int32, pw/pav float32
// (B, S) outputs.  Returns the cudaError_t of the launch.
extern "C" int lora_rotate_detect(const void* zr, const void* zi,
                                  const void* rate, const void* start,
                                  const void* tw, const void* bins, int B,
                                  int S, int n, float scale_db, void* idx,
                                  void* pw, void* pav, void* stream) {
  if (B < 0 || S <= 0 || n > 512) return (int)cudaErrorInvalidValue;
  const lora_rx::RowReader rd{S, (const float*)start};
  return lora_rx::launch_dense_row(
      (const float*)zr, (const float*)zi, nullptr, (const float*)rate,
      nullptr, nullptr, nullptr, (const float*)tw, (const int*)bins, B, rd,
      n, scale_db, (int*)idx, (float*)pw, (float*)pav, (cudaStream_t)stream);
}
