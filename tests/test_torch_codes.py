"""The port's coding toolbox (``ops/codes.py``) against the JAX package's.

The tables and constants are the state the port carries across (LoRa has no
weights): each must equal the JAX module's array bit for bit, dtype and
shape included.  The host functions must return the same arrays on the
same numpy inputs, and the tensor forms of Gray mapping and the diagonal
(de)interleaver must give the JAX package's jnp forms' values, exactly.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")

import torch  # noqa: E402

from lora_sdr_lightweight_standalone_library_clean_tpu.ops import (  # noqa: E402
    codes as jc)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.ops import (  # noqa: E402
    codes as tc)

torch.set_num_threads(1)

TABLES = ("_HDR_PARITY", "_CRC16_TABLE", "_V_SEQ", "_SX1232_KEY_SEQ",
          "_WHITEN_SEQ_WORDS", "_WHITEN_BITS", "_OFS0", "_OFS1",
          "HAMMING84_ENCODE_LUT", "HAMMING84_DECODE_LUT",
          "HAMMING84_ERROR_LUT", "HAMMING84_BAD_LUT", "HAMMING74_ENCODE_LUT",
          "HAMMING74_DECODE_LUT", "HAMMING74_ERROR_LUT")
CONSTANTS = ("HEADER_RDD", "N_HEADER_SYMBOLS", "N_HEADER_CODEWORDS",
             "_WHITEN_LEN", "_LFSR_SEED1", "_LFSR_SEED2", "_M64")


@pytest.mark.parametrize("name", TABLES)
def test_tables_bit_equal(name):
    want, got = getattr(jc, name), getattr(tc, name)
    assert got.dtype == want.dtype and got.shape == want.shape, name
    np.testing.assert_array_equal(got, want)


def test_constants_and_exports_equal():
    for name in CONSTANTS:
        assert getattr(tc, name) == getattr(jc, name), name
    assert tc.__all__ == jc.__all__
    np.testing.assert_array_equal(tc.crc16_table(), jc.crc16_table())


def test_checksums_and_crc_match():
    rng = np.random.default_rng(1)
    for n in (0, 1, 5, 64, 255):
        data = rng.integers(0, 256, n).astype(np.uint8)
        assert tc.checksum8(data) == jc.checksum8(data)
        assert tc.sx1272_data_checksum(data) == jc.sx1272_data_checksum(data)
        assert tc.crc_mask_pair(n) == jc.crc_mask_pair(n)
    assert tc.crc_mask_pair(5000) == jc.crc_mask_pair(5000)
    for h0 in range(256):
        for h1 in range(16):
            assert tc.header_checksum([h0, h1]) == jc.header_checksum(
                [h0, h1])


@pytest.mark.parametrize("rdd", [1, 2, 3, 4])
def test_whitenings_match(rdd):
    rng = np.random.default_rng(rdd)
    data = rng.integers(0, 256, 300).astype(np.uint8)
    for ofs in (0, 3, 17):
        np.testing.assert_array_equal(tc.whiten_sx1272(data, ofs, rdd),
                                      jc.whiten_sx1272(data, ofs, rdd))
        np.testing.assert_array_equal(tc.whiten_sx1272_lfsr(data, ofs, rdd),
                                      jc.whiten_sx1272_lfsr(data, ofs, rdd))
        np.testing.assert_array_equal(
            tc.whitening_sequence_lfsr(40, ofs, rdd),
            jc.whitening_sequence_lfsr(40, ofs, rdd))
    np.testing.assert_array_equal(tc.whiten_sx1232(data),
                                  jc.whiten_sx1232(data))


def test_fec_functions_match():
    nib = np.arange(16, dtype=np.uint8)
    for enc in ("encode_hamming84", "encode_hamming74", "encode_parity54",
                "encode_parity64"):
        np.testing.assert_array_equal(getattr(tc, enc)(nib),
                                      getattr(jc, enc)(nib))
    for dec, n in (("decode_hamming84", 256), ("decode_hamming74", 128),
                   ("check_parity54", 32), ("check_parity64", 64)):
        cw = np.arange(n, dtype=np.uint16 if "hamming" in dec else np.uint8)
        got = getattr(tc, dec)(cw, return_flags=True)
        want = getattr(jc, dec)(cw, return_flags=True)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_gray_host_and_tensor_forms_match():
    """Every 16-bit word (and words past 16 bits, truncated as the JAX
    package's uint16 conversion truncates them) on the host and as tensors
    against the jnp forms."""
    words = np.concatenate([np.arange(1 << 16), [70000, (1 << 20) + 5]])
    for fn in ("binary_to_gray16", "gray_to_binary16"):
        want = np.asarray(getattr(jc, fn)(jnp.asarray(words, jnp.int32)))
        host = getattr(tc, fn)(words)
        assert host.dtype == np.uint16
        np.testing.assert_array_equal(host, want)
        got = getattr(tc, fn)(torch.as_tensor(words, dtype=torch.int32))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert (tc.gray_to_binary16(tc.binary_to_gray16(words[:1 << 16]))
                == words[:1 << 16]).all()


@pytest.mark.parametrize("ppm,rdd", [(5, 4), (7, 1), (7, 4), (8, 2),
                                     (10, 3), (12, 4)])
def test_interleave_host_and_tensor_forms_match(ppm, rdd):
    rng = np.random.default_rng(ppm * 10 + rdd)
    nb = 4 + rdd
    cw = rng.integers(0, 1 << nb, (3, 2, 2 * ppm + 1)).astype(np.uint16)
    want = np.asarray(jc.diagonal_interleave(jnp.asarray(cw), ppm, rdd,
                                             xp=jnp))
    np.testing.assert_array_equal(tc.diagonal_interleave(cw, ppm, rdd),
                                  jc.diagonal_interleave(cw, ppm, rdd))
    got = tc.diagonal_interleave(torch.as_tensor(cw.astype(np.int32)), ppm,
                                 rdd)
    np.testing.assert_array_equal(got.numpy(), want)
    # the inverse, on arbitrary (not only interleaved) symbol words
    sym = rng.integers(0, 1 << 16, (3, 2 * nb + 2)).astype(np.uint16)
    want = np.asarray(jc.diagonal_deinterleave(jnp.asarray(sym), ppm, rdd,
                                               xp=jnp))
    np.testing.assert_array_equal(tc.diagonal_deinterleave(sym, ppm, rdd),
                                  jc.diagonal_deinterleave(sym, ppm, rdd))
    got = tc.diagonal_deinterleave(torch.as_tensor(sym.astype(np.int32)),
                                   ppm, rdd)
    np.testing.assert_array_equal(got.numpy(), want)
    back = tc.diagonal_deinterleave(
        tc.diagonal_interleave(torch.as_tensor(cw.astype(np.int32)), ppm,
                               rdd), ppm, rdd)
    np.testing.assert_array_equal(back.numpy(), cw[..., :2 * ppm])
