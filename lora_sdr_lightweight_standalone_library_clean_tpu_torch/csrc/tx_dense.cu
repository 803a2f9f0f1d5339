// Dense chirp synthesis (osr == 1, n <= 512) for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernel
//   ops/pallas_tx.py:_tx_kernel (called through _tx_call / tx_tone_synth).
//
// What it computes.  At osr == 1 every chirp row of a packet factors into
//   out[b, s, m] = sgn[s] * tab[tone[b, s], m],   tone = (sym * bs) mod n,
// where tab = (wc2, ws2) are the (n, n) tone tables premultiplied by
// base chirp x amplitude (x the demod down-chirp when the output is to be
// pre-dechirped), folded on the host exactly as _tx_call folds them, and
// sgn alternates +-1 along the symbols when bs is odd.  The TPU builds a
// one-hot matrix and multiplies it with the table on its matrix unit
// because that is how it moves rows; on this card the same product is a
// row lookup, so the kernel gathers table rows.
//
// What bounds it on the H100.  It does no arithmetic beyond a sign flip:
// it is bound by the bytes it stores, 2 x 4 B per output sample (the
// tables, 2 x n x n x 4 B <= 2 MiB, stay resident in L2).  The design
// point is the store stream: each thread writes one float4 of re and one
// of im, neighbouring threads on neighbouring addresses, so every warp
// stores whole 512-byte lines; one block covers 256 / (n / 4) rows.
#include <cuda_runtime.h>

namespace {

__global__ void tx_dense_kernel(const int* __restrict__ sym, int rows,
                                int s_total, int n4, int bs, int alt_sign,
                                const float4* __restrict__ wc,
                                const float4* __restrict__ ws,
                                float4* __restrict__ out_re,
                                float4* __restrict__ out_im) {
  const int rows_per_block = blockDim.x / n4;
  const int row = blockIdx.x * rows_per_block + threadIdx.x / n4;
  const int q = threadIdx.x % n4;
  if (row >= rows) return;
  const int n = n4 * 4;
  // (sym * bs) mod n with a non-negative result, like jnp.mod
  int tone = (int)(((long long)sym[row] * bs) % n);
  if (tone < 0) tone += n;
  float4 c = __ldg(wc + (size_t)tone * n4 + q);
  float4 s = __ldg(ws + (size_t)tone * n4 + q);
  if (alt_sign && ((row % s_total) & 1)) {
    c.x = -c.x; c.y = -c.y; c.z = -c.z; c.w = -c.w;
    s.x = -s.x; s.y = -s.y; s.z = -s.z; s.w = -s.w;
  }
  const size_t o = (size_t)row * n4 + q;
  out_re[o] = c;
  out_im[o] = s;
}

}  // namespace

// sym: int32 (rows,) symbol values, rows = packets x (S + 2), row-major;
// wc/ws: float32 (n, n) premultiplied tables; out_re/out_im: float32
// (rows, n).  Returns the cudaError_t of the launch.
extern "C" int lora_tx_dense(const void* sym, int rows, int s_total, int n,
                             int bs, int alt_sign, const void* wc,
                             const void* ws, void* out_re, void* out_im,
                             void* stream) {
  if (n < 4 || n > 512 || (n & (n - 1)) != 0 || rows < 0 || s_total <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) return (int)cudaSuccess;
  const int n4 = n / 4;
  const int threads = 256;                 // n4 <= 128 divides 256
  const int rows_per_block = threads / n4;
  const long long blocks =
      ((long long)rows + rows_per_block - 1) / rows_per_block;
  tx_dense_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)sym, rows, s_total, n4, bs, alt_sign,
      (const float4*)wc, (const float4*)ws, (float4*)out_re,
      (float4*)out_im);
  return (int)cudaGetLastError();
}
