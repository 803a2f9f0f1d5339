"""The framed-decoder kernel's recipe (``csrc/decode_frame.cu``), modelled
row by row in plain Python, against the plain ``decode_frame_padded`` on
the CPU.

The kernel has no CPU mode, so this file holds its formulation to the
plain path instead: the model below computes each row as the kernel does,
with the kernel's own tables (``ops/cuda_frame.py::kernel_tables``), and
must give the plain path's five outputs to the bit.  It follows the
kernel step by step:

  * the header block: the rounded snap to the reduced grid, Gray, and the
    deinterleave at ``sf - 2`` as ``cw[d] = sum_bit ((g[bit] >> ((d - bit)
    mod ppm)) & 1) << bit``, with no index grid;
  * the 5-bit header checksum as the parity of ``((h0 << 4) | h1) & mask``
    for five 12-bit masks (the rows of ``ops/codes.py::_HDR_PARITY``);
  * the body: Gray, the same deinterleave at ``sf``, the whitening key at
    the frame position, the FEC table of the profile's rate;
  * ``n_err`` over the header, the ride-along codewords and the body
    codewords before ``2 * (length + 2 * crc_en) - cap``;
  * the CRC as the XOR of ``step^(L-1-i)(byte i)`` over the first L bytes
    (the position table) and the two LFSR mask bytes;
  * the payload masked past ``length``.

The rows: frames of random lengths up to the bound, frames with a body
symbol moved by n/2 after their CRC was made, headers with another coding
rate, length 0 and lengths past the bound, headers off by one bin on the
reduced grid, noise rows, and random int32 symbols.  The card tests
(``tests/test_torch_cuda.py``) hold the kernel itself to the plain path.
"""
import numpy as np
import pytest
import torch

import lora_sdr_lightweight_standalone_library_clean_tpu_torch as T
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.models import (
    frame as tf)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.ops import (
    codes, cuda_frame)

torch.set_num_threads(1)

CRS = {1: "4/5", 2: "4/6", 3: "4/7", 4: "4/8"}
MAX_LENS = (1, 12, 51, 235, 255)
ROWS = 200


def _parity(x: int) -> int:
    return bin(x).count("1") & 1


def _gray(x: int) -> int:
    return x ^ (x >> 1)


def model_row(s, sf: int, rdd: int, max_len: int, crc: bool, tab):
    """One row as the kernel computes it: (payload list, length, hdr_ok,
    crc_ok, n_err)."""
    g = cuda_frame.geometry(T.LoraParams(sf=sf, cr=CRS[rdd]), max_len, crc)
    ppm, nb, cap = sf - 2, 4 + rdd, g.cap
    # header block: rounded snap, Gray, deinterleave at sf - 2
    hmask = (1 << ppm) - 1
    gh = [_gray(((int(s[j]) + 2) >> 2) & hmask) for j in range(8)]
    cw = [sum(((gh[bit] >> ((d - bit) % ppm)) & 1) << bit
              for bit in range(8)) for d in range(ppm)]
    nib = [0] * g.n_cw
    hn = [int(tab["dec84"][c]) for c in cw[:5]]
    n_err = sum(int(tab["err84"][c]) for c in cw[:5])
    for d in range(5, ppm):
        c = cw[d] ^ int(tab["keys"][d - 5])
        nib[d - 5] = int(tab["dec84"][c])
        n_err += int(tab["err84"][c])
    h0, h1 = (hn[0] << 4) | hn[1], hn[2]
    chk = ((hn[3] & 1) << 4) | hn[4]
    x = (h0 << 4) | h1
    calc_chk = sum(_parity(x & m) << (4 - r)
                   for r, m in enumerate(cuda_frame.HDR_MASKS))
    rdd_f, crc_en = (h1 >> 1) & 7, h1 & 1
    ok = (calc_chk == chk and hn[3] <= 1 and 1 <= rdd_f <= 4 and h0 >= 1)
    length = min(h0, max_len)
    used_body = min(max(2 * (length + 2 * crc_en) - cap, 0),
                    g.body_cw)
    # body: Gray, deinterleave at sf, whitening, FEC
    smask = (1 << sf) - 1
    body = [_gray(int(v) & smask) for v in s[8:g.s_need]]
    for c in range(g.body_cw):
        b, d = divmod(c, sf)
        w = 0
        for bit in range(nb):
            w |= ((body[b * nb + bit] >> ((d - bit) % sf)) & 1) << bit
        w ^= int(tab["keys"][cap + c])
        nib[cap + c] = int(tab["decp"][w])
        if c < used_body:
            n_err += int(tab["errp"][w])

    def by(i):
        return (nib[2 * i] << 4) | nib[2 * i + 1]
    payload = [by(i) if i < length else 0 for i in range(max_len)]
    if crc:
        res = 0
        for i in range(length):
            res ^= int(tab["crc"][(length - 1 - i) * 256 + by(i)])
        vseq = tab["vseq"]
        calc = (res ^ int(vseq[min(length, len(vseq) - 1)])
                ^ (int(vseq[min(length + 1, len(vseq) - 1)]) << 8)) & 0xFFFF
        c0 = by(min(length, g.n_bytes - 1))
        c1 = by(min(length + 1, g.n_bytes - 1))
        crc_ok = (ok and crc_en == 1 and (length + 2) * 2 <= g.n_cw
                  and (c0 | (c1 << 8)) == calc)
    else:
        crc_ok = ok and crc_en == 0
    ok_len = ok and h0 <= max_len and rdd_f == rdd
    return payload, length, ok_len, crc_ok and ok_len, n_err


def _frames(p, lengths, crc, s_need, rng):
    """Framed rows of random payloads of the given lengths (at most 255),
    cut or padded with random symbols to ``s_need``."""
    rows = []
    for n in lengths:
        pay = torch.as_tensor(rng.integers(0, 256, (1, int(n))).astype(
            np.uint8))
        s = T.encode_frame(pay, p, crc=crc)[0].numpy()[:s_need]
        pad = rng.integers(0, p.n, s_need - s.shape[0])
        rows.append(np.concatenate([s, pad]).astype(np.int64))
    return rows


def _rows(sf, rdd, max_len, crc, rng):
    """ROWS rows of every kind the kernel must decode as the plain path
    does, int32 (ROWS, s_need)."""
    p = T.LoraParams(sf=sf, cr=CRS[rdd])
    s_need = T.max_frame_symbols(p, max_len, crc)
    real = _frames(p, rng.integers(1, max_len + 1, 70), crc, s_need, rng)
    # a body symbol moved by n/2 after the CRC was made
    moved = _frames(p, rng.integers(1, max_len + 1, 20), crc, s_need, rng)
    for r in moved:
        if s_need > 8:
            r[rng.integers(8, s_need)] ^= p.n // 2
    # a header symbol off by one bin: the rounded snap keeps the header
    jitter = _frames(p, rng.integers(1, max_len + 1, 10), crc, s_need, rng)
    for r in jitter:
        j = rng.integers(0, 8)
        r[j] = (r[j] + rng.choice([-1, 1])) % p.n
    other = T.LoraParams(sf=sf, cr=CRS[rdd % 4 + 1])
    wrong_rdd = _frames(other, rng.integers(1, max_len + 1, 10), crc,
                        s_need, rng)
    zero = _frames(p, [0] * 5, crc, s_need, rng)
    over = _frames(p, rng.integers(max_len + 1, 256, 10) if max_len < 255
                   else [255] * 10, crc, s_need, rng)
    other_crc = _frames(p, rng.integers(1, max_len + 1, 5), not crc, s_need,
                        rng)
    noise = [rng.integers(0, p.n, s_need) for _ in range(20)]
    words = [rng.integers(0, 2 ** 16, s_need) for _ in range(20)]
    extreme = [rng.choice(np.array([-2 ** 31, -3, -1, 2 ** 31 - 1,
                                    2 ** 31 - 2, 0], np.int64), s_need)
               for _ in range(ROWS - 170)]
    rows = np.stack(real + moved + jitter + wrong_rdd + zero + over
                    + other_crc + noise + words + extreme)
    assert rows.shape == (ROWS, s_need)
    return p, torch.as_tensor(rows.astype(np.int32))


@pytest.mark.parametrize("crc", [True, False])
@pytest.mark.parametrize("rdd", [1, 2, 3, 4])
@pytest.mark.parametrize("sf", [7, 8, 9, 10, 11, 12])
def test_kernel_recipe_equals_plain_decoder(sf, rdd, crc):
    """The model of the kernel's recipe gives the plain path's payload,
    length, hdr_ok, crc_ok and n_err on every row, at a bound from
    MAX_LENS."""
    max_len = MAX_LENS[(sf + rdd + crc) % len(MAX_LENS)]
    rng = np.random.default_rng(sf * 100 + rdd * 10 + crc)
    p, rows = _rows(sf, rdd, max_len, crc, rng)
    want = tf.decode_frame_padded(rows, p, max_len, crc)
    tab = {k: v.numpy() for k, v in
           cuda_frame.kernel_tables(p, max_len, crc,
                                    torch.device("cpu"))._asdict().items()}
    got = [model_row(r, sf, rdd, max_len, crc, tab) for r in rows.numpy()]
    payload, length, hdr_ok, crc_ok, n_err = zip(*got)
    assert np.array_equal(np.array(payload, np.uint8).reshape(ROWS, max_len),
                          want.payload.numpy())
    assert np.array_equal(np.array(length), want.length.numpy())
    assert np.array_equal(np.array(hdr_ok), want.hdr_ok.numpy())
    assert np.array_equal(np.array(crc_ok), want.crc_ok.numpy())
    assert np.array_equal(np.array(n_err), want.n_err.numpy())
    # the rows reach every branch: good frames, failed CRCs, bad headers
    assert want.crc_ok.any() and (want.hdr_ok & ~want.crc_ok).any()
    assert (~want.hdr_ok).any()


def test_header_masks_are_the_parity_matrix():
    """The kernel's five 12-bit masks are the rows of the header checksum's
    parity matrix, column j at bit 11 - j, and give
    ``codes.header_checksum`` on every (h0, h1 nibble)."""
    for r, row in enumerate(codes._HDR_PARITY):
        assert cuda_frame.HDR_MASKS[r] == sum(int(b) << (11 - j)
                                              for j, b in enumerate(row))
    for h0 in range(256):
        for h1 in range(16):
            x = (h0 << 4) | h1
            assert sum(_parity(x & m) << (4 - r) for r, m in
                       enumerate(cuda_frame.HDR_MASKS)) \
                == codes.header_checksum([h0, h1])
