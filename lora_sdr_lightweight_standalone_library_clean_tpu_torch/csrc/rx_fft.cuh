// The FFT shared by the RX kernel bodies rx_dense.cu (n = 4 ... 512) and
// rx_hybrid.cu (n = 1024 ... 16384): step (c) of rx_dense.cu's header.
//
// The algorithm.  An in-place mixed-radix decimation-in-frequency FFT with
// radices r_0 ... r_{P-1} (ops/cuda_rx.py::_fft_radices).  Pass p works on
// N / L_p sub-transforms of L_p = N / (r_0 ... r_{p-1}) points; its
// butterfly b = c * L_{p+1} + m (sub-transform c, position m) takes the r_p
// values at addresses c*L_p + q*L_{p+1} + m, q < r_p, runs their r_p-point
// DFT, multiplies output s by W_{L_p}^{m*s} and writes it back to
// c*L_p + s*L_{p+1} + m: the same addresses, so a pass needs no buffer of
// its own.  Loads are in natural order (pass 0 reads x[m + q*N/r_0]), the
// output lies in digit-reversed order, and no pass reorders it: the
// reduction reads each value's natural bin from the plan's `bins` table.
//
// The tables (ops/cuda_rx.py::_fft_plan, built in float64 and rounded to
// float32 from _fft_twiddles' exp(-2j*pi*k/N)): `tw` holds, for each pass
// but the last, W_{L_p}^{m*s} at tw[table(p) + (s-1)*L_{p+1} + m] as
// (re, im) pairs, s = 1 ... r_p - 1; `bins` holds the natural bin of the
// value that thread (lane) t of a window keeps in register v at the end,
// at bins[v * threads + t].  The r-point DFT inside a pass (r <= 16) runs
// in registers as radix-2 DIF stages whose twiddles W_16^k are the
// compile-time constants below; after it register j holds output brev_r(j).
// No fast trigonometric intrinsic is used anywhere in the FFT.
#pragma once

#include <cuda_runtime.h>

namespace lora_rx {

// W_16^k = exp(-2j*pi*k/16), k = 0 ... 7: float32 roundings of the float64
// values (ops/cuda_rx.py::_W16; tests/test_torch_fft_plan.py reads these
// literals back).  W_16^0 = 1 and W_16^4 = -j are exact and never multiply.
__host__ __device__ constexpr float w16_re(int k) {
  return k == 0 ? 1.0f : k == 1 ? 0.9238795f : k == 2 ? 0.70710677f
       : k == 3 ? 0.38268343f : k == 4 ? 0.0f : k == 5 ? -0.38268343f
       : k == 6 ? -0.70710677f : -0.9238795f;
}
__host__ __device__ constexpr float w16_im(int k) {
  return k == 0 ? 0.0f : k == 1 ? -0.38268343f : k == 2 ? -0.70710677f
       : k == 3 ? -0.9238795f : k == 4 ? -1.0f : k == 5 ? -0.9238795f
       : k == 6 ? -0.70710677f : -0.38268343f;
}

__host__ __device__ constexpr int brev(int j, int r) {
  return r <= 1 ? 0 : ((j & 1) * (r / 2)) | brev(j >> 1, r / 2);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

// a * W_16^K, K known at compile time.
template <int K>
__device__ __forceinline__ float2 w16_mul(float2 a) {
  if constexpr (K == 0) {
    return a;
  } else if constexpr (K == 4) {
    return make_float2(a.y, -a.x);
  } else {
    return cmul(a, make_float2(w16_re(K), w16_im(K)));
  }
}

// One radix-2 DIF stage of an R-point DFT held in x[O ... O+R-1]: pairs
// (j, j + H) of every block of 2H registers, twiddle W_{2H}^{j mod H}.
template <int R, int H, int O, int J = 0>
__device__ __forceinline__ void dif_stage(float2* x) {
  if constexpr (J < R / 2) {
    constexpr int blk = (J / H) * 2 * H, m = J % H;
    const float2 a = x[O + blk + m], b = x[O + blk + m + H];
    x[O + blk + m] = cadd(a, b);
    x[O + blk + m + H] = w16_mul<m * (8 / H)>(csub(a, b));
    dif_stage<R, H, O, J + 1>(x);
  }
}

// The R-point DFT (R = 1, 2, 4, 8, 16) of x[O ... O+R-1] in registers, in
// place; afterwards x[O + j] holds output brev(j, R).
template <int R, int O, int H = R / 2>
__device__ __forceinline__ void dft_regs(float2* x) {
  if constexpr (H >= 1) {
    dif_stage<R, H, O>(x);
    dft_regs<R, O, H / 2>(x);
  }
}

}  // namespace lora_rx
