// Fused packet RX over decimated (osr > 1) and halo windows for Hopper
// (sm_90a): the entry point of the OsrReader instances of rx_dense.cu
// (n <= 512) and rx_hybrid.cu (n = 1024 ... 16384).
//
// Replaces the JAX package's TPU kernel
//   ops/pallas_rx.py:_rx_kernel (called through _rx_call /
//   rx_window_detect) in its padded/slab osr > 1 form (_shifted_windows
//   over the decimation-phase planes that _rx_call builds) and its halo
//   variant (h0, h1 of _shifted_windows_direct, the chunked wide
//   receiver's).
//
// What it computes, per packet b and emitted window e (stream row
// s = h0 + e of S rows of step = n*osr samples; nd = S - h0 - h1 windows
// per packet): the n samples stream[b, s*step + t + i*osr] (the edge rows,
// s = 0 when t < 0 and s = S-1 when t > 0, read the unshifted symbol at
// phase 0), times scale * e^{j*rate*(e*n + t/osr + i)} * mult[i], then
// the n-point FFT and the first-max bin with its power and noise dB
// (rx_common.cuh: window_of_osr, then steps (b)-(d) of rx_dense.cu).  The
// TPU splits the stream into osr decimation-phase planes and selects the
// packet's plane in VMEM, because its block reads are dense; here each
// thread reads its samples with stride osr straight from device memory,
// and no plane is built.
//
// What bounds it on the H100.  The stream read: a strided read still moves
// every DRAM sector of the stream, so the floor is the whole stream's
// 8 B per sample (554 MB for 4,096 sf7/osr2 packets of 66 symbols, about
// 0.17 ms at 3.35 TB/s) although only 1/osr of the samples enter a DFT.
// The kernels are the osr == 1 ones, with the window reader as a template
// parameter, so their osr == 1 instances are unchanged.
#include <cuda_runtime.h>

#include "rx_common.cuh"

// sr/si: float32 (B, S*n*osr) streams; t_off int32 (B,), |t_off| <= n*osr;
// rate/scale float32 (B,); mr/mi float32 (n,) multiplier; tw float32 (K, 2)
// FFT twiddles and bins int32 (n,) natural bins (ops/cuda_rx.py::
// _fft_plan); h0/h1: stream rows that are read but not detected; idx
// int32, pw/pav float32 (B, S - h0 - h1) outputs.  Returns the cudaError_t
// of the launch.
extern "C" int lora_rx_osr(const void* sr, const void* si, const void* t_off,
                           const void* rate, const void* scale,
                           const void* mr, const void* mi, const void* tw,
                           const void* bins, int B, int S, int n, int osr,
                           int h0, int h1, float scale_db, void* idx,
                           void* pw, void* pav, void* stream) {
  const int nd = S - h0 - h1;
  if (B < 0 || S <= 0 || osr < 1 || h0 < 0 || h1 < 0 || nd <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const lora_rx::OsrReader rd{nd, S, osr, h0};
  auto launch = n <= 512 ? lora_rx::launch_dense_osr
                         : lora_rx::launch_hybrid_osr;
  return launch((const float*)sr, (const float*)si, (const int*)t_off,
                (const float*)rate, (const float*)scale, (const float*)mr,
                (const float*)mi, (const float*)tw, (const int*)bins, B, rd,
                n, scale_db, (int*)idx, (float*)pw, (float*)pav,
                (cudaStream_t)stream);
}
