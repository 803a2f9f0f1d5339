// Oversampled chirp synthesis (osr > 1, tone modulus 128 <= q <= 4096) for
// Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernel
//   ops/pallas_tx.py:_tx_osr_kernel (called through _tx_call_osr /
//   tx_tone_synth).
//
// What it computes.  A symbol of n*osr samples is bs chunk rows of
// q = n*osr/bs samples; chunk row r = s*bs + k of a packet holds samples
// k*q ... (k+1)*q - 1 of symbol s.  With t = sym mod q and j the sample
// within the chunk,
//   out[r, j] = tone(t, j) * wt[j]^(g1 + g2) * mult[(s mod P)*bs + k, j],
// where tone(t, j) = exp(2j*pi*t*(j+1)/q) is a row of the dense (q, q)
// tables for q <= 512, or for q > 512 the digit product
// w1[t mod n1, m1] * w2[t, m2] of the factored TX kernel (w2's columns
// rolled by -1, the last lane of each 128-lane block taking its w1 factor
// from block m1 + 1); the gates g1 = (j >= n*osr - sym*osr - k*q) and
// g2 = (j >= 2*n*osr - sym*osr - k*q) each multiply in one factor of the
// wrap tone wt (the frequency wraps of the reference's accumulator,
// ChirpGenerator.hpp:36,44; compiled out when osr divides bs, where
// wt == 1); and mult holds the carry x amplitude x base-chirp chunk
// (x down-chirp chunk), built on the host in float64 for the P row classes
// of the carry period P.  Every product and sum is rounded as the plain
// PyTorch version rounds it (__fmul_rn/__fadd_rn, no contraction into
// FMAs), in the plain version's order: tone, gate 1, gate 2, multiplier.
//
// What bounds it on the H100.  The store: 8 B per output sample, 554 MB for
// 64 sf12/BW500/osr4 packets of 66 symbols, about 0.17 ms at 3.35 TB/s.
// The tables stay in L2 (dense 2 x 1 MB at q = 512; digit tables 2 x 2 MB
// at q = 4096; the multiplier rows 2 x P*bs*q*4 B <= 2 x 128 KB).  The
// design is the one of tx_dense.cu: one thread per four output samples,
// one float4 store of re and one of im, neighbouring threads on
// neighbouring addresses, every offset 64-bit (2^31 samples is 131,072
// sf12/osr4 symbols).
#include <cuda_runtime.h>

namespace {

constexpr int kN2 = 128;                // second digit base (factored tones)
constexpr int kThreads = 256;

__device__ __forceinline__ void cmul(float ac, float as, float bc, float bs,
                                     float* c, float* s) {
  *c = __fsub_rn(__fmul_rn(ac, bc), __fmul_rn(as, bs));
  *s = __fadd_rn(__fmul_rn(ac, bs), __fmul_rn(as, bc));
}

// one gate: (c, s) *= (wc, ws) when the lane has passed the threshold
__device__ __forceinline__ void gate(int lane, long long thr, float wc,
                                     float ws, float* c, float* s) {
  if (lane >= thr) {
    float nc, ns;
    cmul(*c, *s, wc, ws, &nc, &ns);
    *c = nc;
    *s = ns;
  }
}

template <bool kFactored, bool kGated>
__global__ void __launch_bounds__(kThreads)
tx_osr_kernel(const int* __restrict__ sym, long long total4, int s_total,
              int q, int bs, int osr, int period,
              const float* __restrict__ tab_c,
              const float* __restrict__ tab_s,
              const float4* __restrict__ w2c,
              const float4* __restrict__ w2s,
              const float4* __restrict__ wtc,
              const float4* __restrict__ wts,
              const float4* __restrict__ mr, const float4* __restrict__ mi,
              float4* __restrict__ out_re, float4* __restrict__ out_im) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= total4) return;
  const int q4 = q / 4;
  const int row = (int)(g / q4);          // chunk row, < 2^31 (wrapper)
  const int c4 = (int)(g - (long long)row * q4);
  const int srow = row / bs;              // symbol row, packet-major
  const int k = row - srow * bs;          // chunk within the symbol
  const int s = srow % s_total;           // symbol within the packet
  const int sv = __ldg(sym + srow);
  // sym mod q with a non-negative result, like torch.remainder
  int t = sv % q;
  if (t < 0) t += q;

  float c[4], sn[4];
  if (kFactored) {
    const int n1 = q / kN2;
    const int m1 = (c4 * 4) / kN2;                     // digit block
    const int j4 = c4 % (kN2 / 4);                     // float4 in block
    const int m1n = (m1 + 1) % n1;
    const int t1 = t % n1;
    const float gc = __ldg(tab_c + t1 * n1 + m1);
    const float gs = __ldg(tab_s + t1 * n1 + m1);
    const bool wrap = j4 == kN2 / 4 - 1;               // holds j = 127
    const float nc = wrap ? __ldg(tab_c + t1 * n1 + m1n) : gc;
    const float ns = wrap ? __ldg(tab_s + t1 * n1 + m1n) : gs;
    const float4 fc = __ldg(w2c + (size_t)t * (kN2 / 4) + j4);
    const float4 fs = __ldg(w2s + (size_t)t * (kN2 / 4) + j4);
    cmul(gc, gs, fc.x, fs.x, &c[0], &sn[0]);
    cmul(gc, gs, fc.y, fs.y, &c[1], &sn[1]);
    cmul(gc, gs, fc.z, fs.z, &c[2], &sn[2]);
    cmul(nc, ns, fc.w, fs.w, &c[3], &sn[3]);
  } else {
    const float4 a = __ldg((const float4*)tab_c + (size_t)t * q4 + c4);
    const float4 b = __ldg((const float4*)tab_s + (size_t)t * q4 + c4);
    c[0] = a.x; c[1] = a.y; c[2] = a.z; c[3] = a.w;
    sn[0] = b.x; sn[1] = b.y; sn[2] = b.z; sn[3] = b.w;
  }

  if (kGated) {
    // thresholds in within-chunk lane units; they may be negative or
    // beyond q (n*osr = q*bs)
    const long long b_samp = (long long)q * bs;
    const long long thr1 = b_samp - (long long)sv * osr - (long long)k * q;
    const long long thr2 = thr1 + b_samp;
    const float4 a = __ldg(wtc + c4);
    const float4 b = __ldg(wts + c4);
    const float wr[4] = {a.x, a.y, a.z, a.w};
    const float wi[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int lane = c4 * 4 + e;
      gate(lane, thr1, wr[e], wi[e], &c[e], &sn[e]);
      gate(lane, thr2, wr[e], wi[e], &c[e], &sn[e]);
    }
  }

  const size_t m = (size_t)((s % period) * bs + k) * q4 + c4;
  const float4 m_r = __ldg(mr + m);
  const float4 m_i = __ldg(mi + m);
  const float vr[4] = {m_r.x, m_r.y, m_r.z, m_r.w};
  const float vi[4] = {m_i.x, m_i.y, m_i.z, m_i.w};
  float re[4], im[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    re[e] = __fsub_rn(__fmul_rn(c[e], vr[e]), __fmul_rn(sn[e], vi[e]));
    im[e] = __fadd_rn(__fmul_rn(c[e], vi[e]), __fmul_rn(sn[e], vr[e]));
  }
  out_re[g] = make_float4(re[0], re[1], re[2], re[3]);
  out_im[g] = make_float4(im[0], im[1], im[2], im[3]);
}

template <bool kFactored, bool kGated>
int launch(const int* sym, long long total4, int s_total, int q, int bs,
           int osr, int period, const float* tab_c, const float* tab_s,
           const float* w2c, const float* w2s, const float* wtc,
           const float* wts, const float* mr, const float* mi, float* re,
           float* im, cudaStream_t stream) {
  const long long blocks = (total4 + kThreads - 1) / kThreads;
  tx_osr_kernel<kFactored, kGated><<<(unsigned)blocks, kThreads, 0, stream>>>(
      sym, total4, s_total, q, bs, osr, period, tab_c, tab_s,
      (const float4*)w2c, (const float4*)w2s, (const float4*)wtc,
      (const float4*)wts, (const float4*)mr, (const float4*)mi,
      (float4*)re, (float4*)im);
  return (int)cudaGetLastError();
}

}  // namespace

// sym: int32 (rows,) symbol values, rows = packets x (S + 2), row-major;
// q: tone modulus n*osr/bs; period: the carry period P; gated: osr does not
// divide bs.  tab_c/tab_s: float32 (q, q) tone tables (q <= 512) or (n1, n1)
// w1 digit tables (q > 512, with w2c/w2s the float32 (q, 128) column-rolled
// w2 tables; null otherwise); wtc/wts: float32 (q,) wrap tone; mr/mi:
// float32 (P*bs, q) multiplier rows; out_re/out_im: float32
// (rows, n*osr).  Returns the cudaError_t of the launch.
extern "C" int lora_tx_osr(const void* sym, int rows, int s_total, int q,
                           int bs, int osr, int period, int gated,
                           const void* tab_c, const void* tab_s,
                           const void* w2c, const void* w2s, const void* wtc,
                           const void* wts, const void* mr, const void* mi,
                           void* out_re, void* out_im, void* stream) {
  const bool factored = q > 512;
  if (q < 128 || q > 4096 || q % 4 != 0 || (factored && q % kN2 != 0) ||
      rows < 0 || s_total <= 0 || bs < 1 || osr < 2 || period < 1 ||
      (long long)rows * bs > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) return (int)cudaSuccess;
  const long long total4 = (long long)rows * bs * (q / 4);
  auto fn = factored ? (gated ? launch<true, true> : launch<true, false>)
                     : (gated ? launch<false, true> : launch<false, false>);
  return fn((const int*)sym, total4, s_total, q, bs, osr, period,
            (const float*)tab_c, (const float*)tab_s, (const float*)w2c,
            (const float*)w2s, (const float*)wtc, (const float*)wts,
            (const float*)mr, (const float*)mi, (float*)out_re,
            (float*)out_im, (cudaStream_t)stream);
}
