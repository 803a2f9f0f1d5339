// Factored chirp synthesis (osr == 1, n = 1024 ... 4096) for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernel
//   ops/pallas_tx.py:_tx_kernel_factored (called through _tx_call_factored
//   / tx_tone_synth).
//
// What it computes.  For each symbol row with tone t = (sym * bs) mod n,
//   out[row, q] = sgn[s] * mult[q] * w^(t * (q + 1)),   w = exp(2j*pi/n),
// with mult the base chirp x amplitude (x the demod down-chirp) folded on
// the host, and sgn alternating +-1 along the symbols when bs is odd.  The
// tone factor is formed from digit tables exactly as the TPU kernel forms
// it: with m' = (q + 1) mod n = m1*128 + m2,
//   w^(t*m') = w1[t mod n1, m1] * w2[t, m2],   n1 = n / 128,
// where w2's columns are rolled by -1 (column j holds digit (j+1) mod 128)
// and column j = 127 of block m1 takes its w1 factor from block m1 + 1.
// Every product and sum is rounded as the plain PyTorch version rounds it
// (__fmul_rn/__fadd_rn, no contraction into FMAs), so the two agree bit
// for bit.
//
// Why the TPU factored it, and why this kernel keeps the factoring.  The
// TPU needs one-hot matmuls against tables that fit VMEM; the dense (n, n)
// table is 2 x 64 MB at n = 4096, more than VMEM and more than the H100's
// 50 MB L2.  The digit tables are 2 x 2 MB (w2) and 2 x 4 KB (w1) and stay
// in L2.
//
// What bounds it on the H100.  The store: 8 B per output sample, 554 MB
// for 256 sf12 packets of 66 symbols, about 0.17 ms at 3.35 TB/s.  The
// design keeps the store stream of tx_dense.cu (one float4 of re and one of
// im per thread and row, neighbouring threads on neighbouring addresses)
// and takes the table reads off it: a block of 256 threads owns 1024
// output columns for kRows consecutive rows, so each thread keeps its four
// multiplier values in registers across the rows, and each warp covers
// exactly one 128-column digit block m1, so its w1 factor is one broadcast
// load per row.  Output offsets are 64-bit, rows 32-bit.
#include <cuda_runtime.h>

namespace {

constexpr int kN2 = 128;                // second digit base
constexpr int kThreads = 256;           // 1024 output columns per block
constexpr int kRows = 8;                // rows per block

__device__ __forceinline__ void synth(float g_c, float g_s, float f_c,
                                      float f_s, float m_r, float m_i,
                                      bool neg, float* re, float* im) {
  const float tc = __fsub_rn(__fmul_rn(g_c, f_c), __fmul_rn(g_s, f_s));
  const float ts = __fadd_rn(__fmul_rn(g_c, f_s), __fmul_rn(g_s, f_c));
  const float r = __fsub_rn(__fmul_rn(tc, m_r), __fmul_rn(ts, m_i));
  const float i = __fadd_rn(__fmul_rn(ts, m_r), __fmul_rn(tc, m_i));
  *re = neg ? -r : r;
  *im = neg ? -i : i;
}

__global__ void __launch_bounds__(kThreads)
tx_factored_kernel(const int* __restrict__ sym, int rows, int s_total, int n,
                   int bs, int alt_sign, const float* __restrict__ w1c,
                   const float* __restrict__ w1s,
                   const float4* __restrict__ w2c,
                   const float4* __restrict__ w2s,
                   const float4* __restrict__ mr,
                   const float4* __restrict__ mi,
                   float4* __restrict__ out_re, float4* __restrict__ out_im) {
  const int n1 = n / kN2;
  const int n4 = n / 4;
  const int c4 = blockIdx.y * kThreads + threadIdx.x;  // float4 column
  const int m1 = (c4 * 4) / kN2;                       // digit block
  const int j4 = c4 % (kN2 / 4);                       // float4 in block
  const int m1n = (m1 + 1) & (n1 - 1);
  const bool wrap = j4 == kN2 / 4 - 1;                 // holds j = 127
  const float4 m_r = __ldg(mr + c4);
  const float4 m_i = __ldg(mi + c4);
  const int row0 = blockIdx.x * kRows;
#pragma unroll 2
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r;
    if (row >= rows) return;
    // (sym * bs) mod n with a non-negative result, like torch.remainder
    int t = (int)(((long long)__ldg(sym + row) * bs) % n);
    if (t < 0) t += n;
    const int t1 = t & (n1 - 1);
    const float gc = __ldg(w1c + t1 * n1 + m1);
    const float gs = __ldg(w1s + t1 * n1 + m1);
    const float nc = wrap ? __ldg(w1c + t1 * n1 + m1n) : gc;
    const float ns = wrap ? __ldg(w1s + t1 * n1 + m1n) : gs;
    const float4 fc = __ldg(w2c + (size_t)t * (kN2 / 4) + j4);
    const float4 fs = __ldg(w2s + (size_t)t * (kN2 / 4) + j4);
    const bool neg = alt_sign && ((row % s_total) & 1);
    float4 re, im;
    synth(gc, gs, fc.x, fs.x, m_r.x, m_i.x, neg, &re.x, &im.x);
    synth(gc, gs, fc.y, fs.y, m_r.y, m_i.y, neg, &re.y, &im.y);
    synth(gc, gs, fc.z, fs.z, m_r.z, m_i.z, neg, &re.z, &im.z);
    synth(nc, ns, fc.w, fs.w, m_r.w, m_i.w, neg, &re.w, &im.w);
    const size_t o = (size_t)row * n4 + c4;
    out_re[o] = re;
    out_im[o] = im;
  }
}

}  // namespace

// sym: int32 (rows,) symbol values, rows = packets x (S + 2), row-major;
// w1c/w1s: float32 (n1, n1) digit tables; w2c/w2s: float32 (n, 128)
// column-rolled digit tables; mr/mi: float32 (n,) multiplier; out_re/out_im:
// float32 (rows, n).  Returns the cudaError_t of the launch.
extern "C" int lora_tx_factored(const void* sym, int rows, int s_total, int n,
                                int bs, int alt_sign, const void* w1c,
                                const void* w1s, const void* w2c,
                                const void* w2s, const void* mr,
                                const void* mi, void* out_re, void* out_im,
                                void* stream) {
  if (n < 1024 || n > 4096 || (n & (n - 1)) != 0 || rows < 0 ||
      s_total <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)(((long long)rows + kRows - 1) / kRows),
                  (unsigned)(n / 4 / kThreads));
  tx_factored_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)sym, rows, s_total, n, bs, alt_sign, (const float*)w1c,
      (const float*)w1s, (const float4*)w2c, (const float4*)w2s,
      (const float4*)mr, (const float4*)mi, (float4*)out_re,
      (float4*)out_im);
  return (int)cudaGetLastError();
}
