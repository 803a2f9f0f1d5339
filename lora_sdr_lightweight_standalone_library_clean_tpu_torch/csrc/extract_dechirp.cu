// Packet extraction and dechirp of the streaming receivers, for Hopper
// (sm_90a): the port's own kernel, with no TPU kernel behind it.
//
// The JAX package's receiver (parallel/receiver.py:263-268) slices each
// packet out of [tail | chunk] with a vmapped lax.dynamic_slice_in_dim and
// multiplies it by the tiled down-chirp (models/modem.py::dechirp), and XLA
// fuses the two on the TPU.  Run eagerly, the same step is eight PyTorch
// kernels (a gather per plane, four products, a subtraction, an addition),
// each writing a full (K, plen) float32 plane that the next one reads back.
//
// What it computes, for each row k < K and sample j < plen:
//   x  = ext[pos[k] + j] on both planes (zero where pos[k] + j lies outside
//        [0, len): the receivers clamp their starts to len - plen, so they
//        never read there);
//   dr = xr * dcr[j % step] - xi * dci[j % step],
//   di = xr * dci[j % step] + xi * dcr[j % step],
// each product and sum rounded on its own (__fmul_rn, __fsub_rn, __fadd_rn:
// no FMA contraction), as PyTorch's separate kernels round them, so the
// rows are bit-equal to dechirp(ext.unfold(0, plen, 1).index_select(0, pos)).
// dcr/dci is the one-symbol down-chirp (step entries), not a tiled table.
//
// What bounds it on the H100.  It does no arithmetic to speak of: 8 B
// written a sample and, per row, plen samples read from the stream.  Rows
// of one frame overlap, and the sentinel rows of a partly empty chunk all
// start at 0, so the reads that reach device memory are about one pass
// over the stream: the bound is the written rows plus one read of the
// stream at 3.35 TB/s.  The design:
//   - each warp stages 256 samples of a row per plane in shared memory
//     with coalesced scalar loads (a start need not be aligned), then each
//     lane takes 4 neighbouring samples and writes them with aligned
//     16-byte streaming stores (rows start at multiples of plen, a
//     multiple of step and so of 4); the streaming stores keep the
//     written rows from pushing the stream out of L2;
//   - the down-chirp is read as aligned float4s through the read-only
//     cache, where it stays (at most 64 KB a plane);
//   - block b holds tile b % tiles of row b / tiles, so the grid walks the
//     rows in the order of pos (the receivers' starts come sorted), and
//     rows that overlap are read close together in time, their second
//     reads served from L2;
//   - sample and output offsets are 64-bit, so a stream may pass 2^31
//     samples.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                       // warps a block
constexpr int kWarpSamples = 256;               // samples a warp, per plane
constexpr int kTile = kWarps * kWarpSamples;    // samples a block

__global__ void __launch_bounds__(kWarps * 32)
extract_dechirp_kernel(const float* __restrict__ sr,
                       const float* __restrict__ si, long long len,
                       const long long* __restrict__ pos, int plen,
                       int tiles, const float4* __restrict__ cr,
                       const float4* __restrict__ ci, int step,
                       float4* __restrict__ out_r,
                       float4* __restrict__ out_i) {
  __shared__ __align__(16) float stage_r[kWarps][kWarpSamples];
  __shared__ __align__(16) float stage_i[kWarps][kWarpSamples];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x / tiles;
  const int j0 = (blockIdx.x - row * tiles) * kTile + warp * kWarpSamples;
  if (j0 >= plen) return;  // the whole warp lies past the row's end
  const long long src = pos[row] + j0;
#pragma unroll
  for (int r = 0; r < kWarpSamples / 32; ++r) {
    const int e = lane + 32 * r;
    const long long q = src + e;
    const bool in = j0 + e < plen &&
                    (unsigned long long)q < (unsigned long long)len;
    stage_r[warp][e] = in ? sr[q] : 0.0f;
    stage_i[warp][e] = in ? si[q] : 0.0f;
  }
  __syncwarp();
  const long long row_base = (long long)row * plen;
#pragma unroll
  for (int h = 0; h < kWarpSamples / 128; ++h) {
    const int e = 4 * (lane + 32 * h);
    const int j = j0 + e;
    if (j >= plen) break;  // plen % 4 == 0: a float4 is all in or all out
    const float4 xr = *reinterpret_cast<const float4*>(&stage_r[warp][e]);
    const float4 xi = *reinterpret_cast<const float4*>(&stage_i[warp][e]);
    const float4 c = __ldg(cr + (j % step) / 4);
    const float4 s = __ldg(ci + (j % step) / 4);
    float4 rr, ri;
    rr.x = __fsub_rn(__fmul_rn(xr.x, c.x), __fmul_rn(xi.x, s.x));
    rr.y = __fsub_rn(__fmul_rn(xr.y, c.y), __fmul_rn(xi.y, s.y));
    rr.z = __fsub_rn(__fmul_rn(xr.z, c.z), __fmul_rn(xi.z, s.z));
    rr.w = __fsub_rn(__fmul_rn(xr.w, c.w), __fmul_rn(xi.w, s.w));
    ri.x = __fadd_rn(__fmul_rn(xr.x, s.x), __fmul_rn(xi.x, c.x));
    ri.y = __fadd_rn(__fmul_rn(xr.y, s.y), __fmul_rn(xi.y, c.y));
    ri.z = __fadd_rn(__fmul_rn(xr.z, s.z), __fmul_rn(xi.z, c.z));
    ri.w = __fadd_rn(__fmul_rn(xr.w, s.w), __fmul_rn(xi.w, c.w));
    const long long o = (row_base + j) / 4;
    __stcs(out_r + o, rr);
    __stcs(out_i + o, ri);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

}  // namespace

// sr/si: float32 (len,) planes of [tail | chunk]; pos int64 (K,) row
// starts; cr/ci float32 (step,) one-symbol down-chirp; out_r/out_i float32
// (K, plen).  plen and step multiples of 4, step | plen, K * tiles below
// 2^31; the table and outputs 16-byte aligned.  K = 0 launches nothing.
// Returns the cudaError_t of the launch.
extern "C" int lora_extract_dechirp(const void* sr, const void* si,
                                    long long len, const void* pos, int K,
                                    int plen, const void* cr, const void* ci,
                                    int step, void* out_r, void* out_i,
                                    void* stream) {
  if (len < 0 || K < 0 || plen <= 0 || step <= 0 || step % 4 ||
      plen % step || !aligned16(cr) || !aligned16(ci) ||
      !aligned16(out_r) || !aligned16(out_i)) {
    return (int)cudaErrorInvalidValue;
  }
  if (K == 0) return (int)cudaSuccess;
  const int tiles = (plen + kTile - 1) / kTile;
  if ((long long)K * tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  extract_dechirp_kernel<<<K * tiles, kWarps * 32, 0,
                           (cudaStream_t)stream>>>(
      (const float*)sr, (const float*)si, len, (const long long*)pos, plen,
      tiles, (const float4*)cr, (const float4*)ci, step, (float4*)out_r,
      (float4*)out_i);
  return (int)cudaGetLastError();
}
