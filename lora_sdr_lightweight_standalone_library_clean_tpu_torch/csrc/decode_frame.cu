// The framed decoder of the SX1272 codec, for Hopper (sm_90a): the port's
// own kernel, with no TPU kernel behind it.
//
// The JAX package's framed codec (models/frame.py::decode_frame_padded) is
// jnp code that XLA fuses on the TPU.  Run eagerly, the same decoder is
// about a hundred small PyTorch kernels a call, and its diagonal
// deinterleave copied index grids from the host on every call, each copy a
// wait for the card.  This kernel decodes every row in one launch.
//
// What it computes, for each row of int32 symbols s (models/frame.py's
// plain decode_frame_padded_ref, step for step, in integer arithmetic):
//   - the header block: g[j] = gray(((s[j] + 2) >> 2) & (2^(sf-2) - 1)) for
//     j < 8, the deinterleave at ppm = sf - 2 as
//     cw[d] = sum_bit ((g[bit] >> ((d - bit) mod ppm)) & 1) << bit, computed
//     in place of a host index grid, and Hamming 8/4 on the first five
//     codewords; the other sf - 7 are ride-along payload codewords,
//     dewhitened with the first keys;
//   - h0, h1 and the 5-bit checksum (the parity of (h0 << 4 | h1) under the
//     five rows of ops/codes.py::_HDR_PARITY), the field checks, and
//     length = min(h0, max_len);
//   - the body: gray(s & (2^sf - 1)), the same deinterleave at sf over
//     blocks of 4 + rdd symbols, the whitening key at each frame position
//     and the FEC table of the profile's rate;
//   - n_err over the header and ride-along codewords and the body codewords
//     the frame uses (those before 2 * (length + 2 * crc_en) - cap);
//   - the bytes, the CRC as the XOR over the first length bytes of
//     step^(length - 1 - i)(byte i) (the plain path's position table) with
//     the two LFSR mask bytes, and the payload masked past length.
//
// What bounds it on the H100.  Bytes: each row's symbols are read once
// (1,392 B at GF7's 348 symbols) and its outputs written once (max_len + 10
// B); the arithmetic is a few hundred integer operations a row.  At 12,660
// rows that is 17.6 MB read and 3.2 MB written, about 6 us at 3.35 TB/s.
// The design:
//   - one warp a row, eight rows a block; the lanes read the row's symbols
//     coalesced, map them to Gray values as they land in shared memory
//     (16 bits each), and build the codewords from there, so the row
//     crosses device memory once and every later access is shared memory;
//   - the Hamming 8/4 and profile tables sit in shared memory, each entry a
//     nibble with its error flag above it; the whitening keys are read
//     coalesced through the read-only cache;
//   - the nibbles go to shared memory, the bytes are formed from pairs of
//     them, and the CRC's per-byte contributions are gathered from the
//     position table (L2-resident, n_bytes * 1 KB) and XOR-reduced with
//     shuffles; n_err is a ballot and a shuffle sum;
//   - the grid walks the rows in order, so the reads stream.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;              // rows a block, at most
constexpr int kTables = 512;           // shared bytes of the two FEC tables
constexpr int kSharedMax = 48 * 1024;  // without an opt-in
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const int* sym;       // (K, S) symbols, row-major
  int K, S;
  int sf, rdd, max_len, crc;
  int cap, body_cw, n_cw, n_bytes, s_need;
  int warp_bytes, nib_at;  // a warp's shared bytes, its nibbles' offset
  const int* dec84;     // (256,)
  const int* err84;
  const int* decp;      // (2^(4+rdd),)
  const int* errp;
  const int* keys;      // (n_cw,)
  const int* crc_tab;   // (n_bytes * 256,)
  const int* vseq;      // (vseq_len,)
  int vseq_len;
  unsigned char* payload;  // (K, max_len)
  int* length;
  unsigned char* hdr_ok;
  unsigned char* crc_ok;
  int* n_err;
};

// The explicit header's 5-bit checksum of x = (h0 << 4) | h1: bit 4 - r is
// the parity of x under row r of the parity matrix (ops/codes.py::
// _HDR_PARITY, column j at bit 11 - j; ops/cuda_frame.py::HDR_MASKS).
__device__ __forceinline__ int header_checksum(int x) {
  return ((__popc(x & 0xF00) & 1) << 4) | ((__popc(x & 0x8E1) & 1) << 3) |
         ((__popc(x & 0x49A) & 1) << 2) | ((__popc(x & 0x257) & 1) << 1) |
         (__popc(x & 0x12F) & 1);
}

__device__ __forceinline__ int byte_at(const unsigned char* nib, int i) {
  return (nib[2 * i] << 4) | nib[2 * i + 1];
}

__global__ void __launch_bounds__(kWarps * 32)
decode_frame_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* fec84 = smem;         // nibble | error << 4
  unsigned char* fecp = smem + 256;
  const int nfecp = 1 << (4 + a.rdd);
  for (int c = threadIdx.x; c < 256; c += blockDim.x) {
    fec84[c] = (unsigned char)(__ldg(a.dec84 + c) | (__ldg(a.err84 + c) << 4));
    fecp[c] = c < nfecp ? (unsigned char)(__ldg(a.decp + c) |
                                          (__ldg(a.errp + c) << 4))
                        : 0;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= a.K) return;
  unsigned char* mine = smem + kTables + warp * a.warp_bytes;
  unsigned short* g = reinterpret_cast<unsigned short*>(mine);
  unsigned char* nib = mine + a.nib_at;
  const int sf = a.sf, ppm = sf - 2, nb = 4 + a.rdd;

  // the row's symbols, read once, as Gray values: the header block's on
  // the reduced grid with rounding, the body's on the full one
  const int* src = a.sym + (long long)row * a.S;
  const unsigned hmask = (1u << ppm) - 1, smask = (1u << sf) - 1;
#pragma unroll 4
  for (int j = lane; j < a.s_need; j += 32) {
    const unsigned v = (unsigned)__ldcs(src + j);
    const unsigned b = j < 8 ? ((v + 2u) >> 2) & hmask : v & smask;
    g[j] = (unsigned short)(b ^ (b >> 1));
  }
  __syncwarp();

  // header block: lane d < ppm builds codeword d
  int hcw = 0;
  if (lane < ppm) {
    for (int bit = 0; bit < 8; ++bit) {  // 8 bits > ppm at sf 7 and 8
      const int p = (lane - bit + 2 * ppm) % ppm;
      hcw |= ((g[bit] >> p) & 1) << bit;
    }
  }
  int hnib = 0, herr = 0;
  if (lane < 5) {
    const int e = fec84[hcw];
    hnib = e & 15;
    herr = e >> 4;
  } else if (lane < ppm) {          // ride-along: CR 4/8, whitened
    const int e = fec84[hcw ^ __ldg(a.keys + lane - 5)];
    nib[lane - 5] = (unsigned char)(e & 15);
    herr = e >> 4;
  }
  int n_err = __popc(__ballot_sync(kFull, herr));
  const int n0 = __shfl_sync(kFull, hnib, 0);
  const int n1 = __shfl_sync(kFull, hnib, 1);
  const int h1 = __shfl_sync(kFull, hnib, 2);
  const int n3 = __shfl_sync(kFull, hnib, 3);
  const int n4 = __shfl_sync(kFull, hnib, 4);
  const int h0 = (n0 << 4) | n1;
  const int rdd_f = (h1 >> 1) & 7;
  const int crc_en = h1 & 1;
  const bool ok = header_checksum((h0 << 4) | h1) == (((n3 & 1) << 4) | n4) &&
                  n3 <= 1 && rdd_f >= 1 && rdd_f <= 4 && h0 >= 1;
  const int length = min(h0, a.max_len);
  const int used_body =
      min(max(2 * (length + 2 * crc_en) - a.cap, 0), a.body_cw);

  // body: codeword c of block c / sf at d = c % sf
  int berr = 0;
  for (int c = lane; c < a.body_cw; c += 32) {
    const int b = c / sf;
    const int d = c - b * sf;
    const unsigned short* s = g + 8 + b * nb;
    int w = 0;
    for (int bit = 0; bit < nb; ++bit) {  // nb <= 8 <= sf + 1
      int p = d - bit;
      if (p < 0) p += sf;
      w |= ((s[bit] >> p) & 1) << bit;
    }
    const int e = fecp[w ^ __ldg(a.keys + a.cap + c)];
    nib[a.cap + c] = (unsigned char)(e & 15);
    if (c < used_body) berr += e >> 4;
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) berr += __shfl_xor_sync(kFull, berr, o);
  n_err += berr;
  __syncwarp();

  // bytes: the masked payload and the CRC's contributions
  unsigned char* out = a.payload + (long long)row * a.max_len;
  int x = 0;
  for (int i = lane; i < a.max_len; i += 32) {
    const int by = byte_at(nib, i);
    const bool in = i < length;
    out[i] = in ? (unsigned char)by : 0;
    if (a.crc && in) x ^= __ldg(a.crc_tab + (length - 1 - i) * 256 + by);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) x ^= __shfl_xor_sync(kFull, x, o);
  if (lane == 0) {
    bool crc_ok;
    if (a.crc) {
      const int top = a.vseq_len - 1;
      const int calc = (x ^ __ldg(a.vseq + min(length, top)) ^
                        (__ldg(a.vseq + min(length + 1, top)) << 8)) &
                       0xFFFF;
      const int c0 = byte_at(nib, min(length, a.n_bytes - 1));
      const int c1 = byte_at(nib, min(length + 1, a.n_bytes - 1));
      crc_ok = ok && crc_en && (length + 2) * 2 <= a.n_cw &&
               (c0 | (c1 << 8)) == calc;
    } else {
      crc_ok = ok && !crc_en;
    }
    const bool ok_len = ok && h0 <= a.max_len && rdd_f == a.rdd;
    a.length[row] = length;
    a.hdr_ok[row] = ok_len;
    a.crc_ok[row] = crc_ok && ok_len;
    a.n_err[row] = n_err;
  }
}

int round4(int n) { return (n + 3) & ~3; }

}  // namespace

// sym: int32 (K, S) symbols; sf 7..12, rdd 1..4, max_len >= 0, crc 0/1;
// body_cw = the padded decoder's body codewords (a multiple of sf), so that
// 8 + body_cw / sf * (4 + rdd) <= S and max_len <= (sf - 7 + body_cw) / 2;
// dec84/err84 int32 (256,), decp/errp int32 (2^(4+rdd),), keys int32
// (sf - 7 + body_cw,), crc_tab int32 (n_bytes * 256,), vseq int32
// (vseq_len,); outputs payload uint8 (K, max_len), length int32 (K,),
// hdr_ok and crc_ok bool (K,), n_err int32 (K,).  K = 0 launches nothing.
// Returns the cudaError_t of the launch.
extern "C" int lora_decode_frame(const void* sym, int K, int S, int sf,
                                 int rdd, int max_len, int crc, int body_cw,
                                 const void* dec84, const void* err84,
                                 const void* decp, const void* errp,
                                 const void* keys, const void* crc_tab,
                                 const void* vseq, int vseq_len,
                                 void* payload, void* length, void* hdr_ok,
                                 void* crc_ok, void* n_err, void* stream) {
  if (K < 0 || sf < 7 || sf > 12 || rdd < 1 || rdd > 4 || max_len < 0 ||
      body_cw < 0 || body_cw % sf || vseq_len < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.cap = sf - 7;
  a.body_cw = body_cw;
  a.n_cw = a.cap + body_cw;
  a.n_bytes = a.n_cw / 2;
  a.s_need = 8 + body_cw / sf * (4 + rdd);
  if (a.s_need > S || max_len > a.n_bytes || (crc && a.n_bytes < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  a.nib_at = round4(2 * a.s_need);
  a.warp_bytes = a.nib_at + round4(a.n_cw);
  int warps = (kSharedMax - kTables) / a.warp_bytes;
  if (warps < 1) return (int)cudaErrorInvalidValue;
  if (warps > kWarps) warps = kWarps;
  if (K == 0) return (int)cudaSuccess;
  a.sym = (const int*)sym;
  a.K = K;
  a.S = S;
  a.sf = sf;
  a.rdd = rdd;
  a.max_len = max_len;
  a.crc = crc ? 1 : 0;
  a.dec84 = (const int*)dec84;
  a.err84 = (const int*)err84;
  a.decp = (const int*)decp;
  a.errp = (const int*)errp;
  a.keys = (const int*)keys;
  a.crc_tab = (const int*)crc_tab;
  a.vseq = (const int*)vseq;
  a.vseq_len = vseq_len;
  a.payload = (unsigned char*)payload;
  a.length = (int*)length;
  a.hdr_ok = (unsigned char*)hdr_ok;
  a.crc_ok = (unsigned char*)crc_ok;
  a.n_err = (int*)n_err;
  const int blocks = (K + warps - 1) / warps;
  decode_frame_kernel<<<blocks, warps * 32, kTables + warps * a.warp_bytes,
                        (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
