"""The port's SX1272 framed codec (``models/frame.py``) against the JAX
package's, on the CPU.

Same numpy payloads and symbol rows through both packages: on-air symbols,
decoded bytes, lengths, header and CRC verdicts and ``n_err`` exact (the
codec is integer arithmetic); through the air (``encode_frame ->
modulate_dechirped -> demodulate_tones -> decode_frame_padded``, with AWGN
from one numpy draw) symbols and bytes exact, CFO within 1e-5 and timing
within 1e-3 samples, the slice tolerances of tests/test_torch_parity.py.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")

import torch  # noqa: E402

import lora_sdr_lightweight_standalone_library_clean_tpu as J  # noqa: E402
from lora_sdr_lightweight_standalone_library_clean_tpu.models import (  # noqa: E402
    frame as jf)

import lora_sdr_lightweight_standalone_library_clean_tpu_torch as T  # noqa: E402
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.models import (  # noqa: E402
    frame as tf)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.utils.errors import (  # noqa: E402
    InvalidArgumentError)

torch.set_num_threads(1)

CRS = {1: "4/5", 2: "4/6", 3: "4/7", 4: "4/8"}


def _params(sf, rdd=1):
    return J.LoraParams(sf=sf, cr=CRS[rdd]), T.LoraParams(sf=sf, cr=CRS[rdd])


def _jax_encode(pay, jp, crc=True):
    """The JAX package's encoder, jitted (eager dispatch compiles each op
    for each new shape, several seconds a call on the CPU)."""
    return np.asarray(jax.jit(functools.partial(
        jf.encode_frame, params=jp, crc=crc))(pay))


def _jax_decode_padded(rows, jp, max_len, crc=True):
    return jax.jit(functools.partial(
        jf.decode_frame_padded, params=jp, max_payload_len=max_len,
        crc=crc))(rows.astype(np.uint16))


def _assert_result_equal(tres, jres):
    for f in jres._fields:
        want = np.asarray(getattr(jres, f))
        got = getattr(tres, f).numpy()
        assert got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("rdd", [1, 2, 3, 4])
@pytest.mark.parametrize("sf", [7, 8, 9, 10, 11, 12])
def test_encode_and_decode_match_jax(sf, rdd):
    """A batch of payloads of one length: symbols exact, the padded decode
    of clean and corrupted rows (one Gray bit in the header block, two in a
    body symbol, a burst beyond FEC reach) equal field for field.  Half the
    cases carry no CRC (each sf and each rate both ways)."""
    crc = (sf + rdd) % 2 == 0
    jp, tp = _params(sf, rdd)
    rng = np.random.default_rng(sf * 10 + rdd)
    pay = rng.integers(0, 256, (4, 13)).astype(np.uint8)
    jsym = _jax_encode(pay, jp, crc)
    tsym = tf.encode_frame(torch.as_tensor(pay), tp, crc)
    assert tsym.dtype == torch.int32
    np.testing.assert_array_equal(tsym.numpy(), jsym)
    assert tsym.shape[-1] == tf.frame_symbols(tp, 13, crc) == \
        jf.frame_symbols(jp, 13, crc)

    max_len = 20
    s_max = tf.max_frame_symbols(tp, max_len, crc)
    assert s_max == jf.max_frame_symbols(jp, max_len, crc)
    rows = np.zeros((4, s_max), np.int64)
    rows[:, :jsym.shape[-1]] = jsym
    rows[1, 3] ^= 1 << 2                    # header block, reduced grid
    rows[2, 10] ^= 0x3
    rows[3, 8:12] ^= 0x55
    jres = _jax_decode_padded(rows, jp, max_len, crc)
    tres = tf.decode_frame_padded(torch.as_tensor(rows), tp, max_len, crc)
    _assert_result_equal(tres, jres)
    assert tres.hdr_ok[0] and tres.crc_ok[0]
    np.testing.assert_array_equal(tres.payload[0, :13].numpy(), pay[0])
    th = tf.decode_header(torch.as_tensor(rows[:, :8]), tp)
    assert torch.equal(th.hdr_ok, tres.hdr_ok | (th.length > max_len))
    np.testing.assert_array_equal(th.length.numpy()[th.hdr_ok.numpy()],
                                  np.asarray(jres.length)[th.hdr_ok.numpy()])


def test_padded_decoder_mixed_lengths_oversize_and_wrong_rate_match_jax():
    """One padded decode of frames of lengths 1..24 at max 16 (longer ones
    oversize), and a frame at another coding rate: every field equal."""
    jp, tp = _params(7, 1)
    _, tp8 = _params(7, 4)
    max_len = 16
    s_max = tf.max_frame_symbols(tp, max_len)
    rng = np.random.default_rng(3)
    lengths = list(range(1, 25, 2))
    rows = np.zeros((len(lengths) + 1, s_max), np.int64)
    for i, ln in enumerate(lengths):
        s = tf.encode_frame(torch.as_tensor(rng.integers(0, 256, ln)), tp)
        rows[i, :min(s_max, s.shape[-1])] = s.numpy()[:s_max]
    s8 = tf.encode_frame(torch.as_tensor(rng.integers(0, 256, 4)), tp8)
    rows[-1, :min(s_max, s8.shape[-1])] = s8.numpy()[:s_max]
    jres = _jax_decode_padded(rows, jp, max_len)
    tres = tf.decode_frame_padded(torch.as_tensor(rows), tp, max_len)
    _assert_result_equal(tres, jres)
    want_ok = [ln <= max_len for ln in lengths] + [False]
    assert tres.hdr_ok.numpy().tolist() == want_ok
    assert tres.crc_ok.numpy().tolist() == want_ok


def test_decode_frame_exact_size_matches_jax():
    jp, tp = _params(8, 2)
    pay = np.random.default_rng(5).integers(0, 256, 14).astype(np.uint8)
    sym = tf.encode_frame(torch.as_tensor(pay), tp)
    tres = tf.decode_frame(sym, tp)
    jres = jf.decode_frame(sym.numpy().astype(np.uint16), jp)
    _assert_result_equal(tres, jres)
    np.testing.assert_array_equal(tres.payload.numpy(), pay)
    bad = sym.clone()
    bad[:4] ^= 0x54                        # header beyond FEC reach
    tbad = tf.decode_frame(bad, tp)
    jbad = jf.decode_frame(bad.numpy().astype(np.uint16), jp)
    _assert_result_equal(tbad, jbad)
    assert not bool(tbad.hdr_ok) and tbad.payload.numel() == 0
    with pytest.raises(InvalidArgumentError):
        tf.decode_frame(sym[:-1], tp)


def test_header_checksum_and_dynamic_crc_match_jax():
    h0, h1 = np.meshgrid(np.arange(256), np.arange(16), indexing="ij")
    np.testing.assert_array_equal(
        tf.header_checksum_batch(torch.as_tensor(h0), torch.as_tensor(h1))
        .numpy(), np.asarray(jf.header_checksum_batch(h0, h1)))
    rng = np.random.default_rng(8)
    data = rng.integers(0, 256, (6, 40)).astype(np.uint8)
    lengths = np.array([0, 1, 7, 31, 40, 55])
    want = np.asarray(jf.crc_sx1272_at(data, lengths)).astype(np.int64)
    got = tf.crc_sx1272_at(torch.as_tensor(data), torch.as_tensor(lengths))
    np.testing.assert_array_equal(got.numpy(), want)
    for k in range(1, 4):
        assert int(got[k]) == T.crc_sx1272(
            torch.as_tensor(data[k, :lengths[k]])).item()


def test_sf_below_seven_and_bad_rate_raise():
    with pytest.raises(InvalidArgumentError):
        tf.encode_frame(torch.zeros(4, dtype=torch.uint8), T.LoraParams(sf=6))
    with pytest.raises(InvalidArgumentError):
        tf.decode_frame_padded(torch.zeros(3, dtype=torch.int32),
                               T.LoraParams(sf=7), 8)


@pytest.mark.parametrize("sf,cr", [(7, "4/5"), (9, "4/7"), (12, "4/8")])
def test_framed_slice_matches_jax(sf, cr):
    """encode_frame -> modulate_dechirped -> (AWGN sigma 0.2) ->
    demodulate_tones -> decode_frame_padded in both packages on the same
    payloads of mixed lengths and the same noise."""
    jp, tp = J.LoraParams(sf=sf, cr=cr), T.LoraParams(sf=sf, cr=cr)
    max_len = 12
    rng = np.random.default_rng(sf)
    lengths = [1, 5, 12, 9]
    s_max = tf.max_frame_symbols(tp, max_len)
    rows = np.zeros((len(lengths), s_max), np.int64)
    pays = []
    for i, ln in enumerate(lengths):
        pays.append(rng.integers(0, 256, ln).astype(np.uint8))
        s = tf.encode_frame(torch.as_tensor(pays[-1]), tp).numpy()
        rows[i, :s.shape[-1]] = s
    jdr, jdi = J.modulate_dechirped(rows.astype(np.uint16), jp)
    noise = rng.standard_normal((2,) + jdr.shape).astype(np.float32) * 0.2
    dr = (np.asarray(jdr) + noise[0]).astype(np.float32)
    di = (np.asarray(jdi) + noise[1]).astype(np.float32)
    jres = J.demodulate_tones(jnp.asarray(dr), jnp.asarray(di), jp)
    jdec = _jax_decode_padded(np.asarray(jres.symbols), jp, max_len)

    tdr, tdi = T.modulate_dechirped(torch.as_tensor(rows), tp)
    np.testing.assert_allclose(tdr.numpy(), np.asarray(jdr), atol=4e-6,
                               rtol=0)
    tres = T.demodulate_tones(torch.as_tensor(dr), torch.as_tensor(di), tp)
    tdec = tf.decode_frame_padded(tres.symbols, tp, max_len)
    np.testing.assert_array_equal(tres.symbols.numpy(),
                                  np.asarray(jres.symbols))
    np.testing.assert_allclose(tres.cfo.numpy(), np.asarray(jres.cfo),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(tres.time_offset.numpy(),
                               np.asarray(jres.time_offset), atol=1e-3,
                               rtol=0)
    _assert_result_equal(tdec, jdec)
    assert tdec.crc_ok.all()
    for i, ln in enumerate(lengths):
        np.testing.assert_array_equal(tdec.payload[i, :ln].numpy(), pays[i])
