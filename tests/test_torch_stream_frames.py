"""The port's header-driven streaming receiver (``receive_stream_frames``,
``stream_frames_init``, ``RecoveredFrames``) against the JAX package's, on
the CPU, in the cases of tests/test_stream_frames.py.

Streams are made with numpy from fixed seeds (framed packets built by the
JAX package's codec and modulator, then noise) and handed to both packages.
Tolerances: payload, length, hdr_ok, crc_ok, valid, start, sync_word,
n_err, n_candidates and n_dropped exact; CFO within 1e-5 and timing within
1e-3 samples.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")

import torch  # noqa: E402

import lora_sdr_lightweight_standalone_library_clean_tpu as J  # noqa: E402
from lora_sdr_lightweight_standalone_library_clean_tpu.models import (  # noqa: E402
    frame as jframe)
from lora_sdr_lightweight_standalone_library_clean_tpu.parallel import (  # noqa: E402
    receiver as jrx)

import lora_sdr_lightweight_standalone_library_clean_tpu_torch as T  # noqa: E402
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.parallel import (  # noqa: E402
    receiver as trx)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.utils import (  # noqa: E402
    errors as terrors)

torch.set_num_threads(1)

MAX_LEN = 16
EXACT = ("payload", "length", "hdr_ok", "crc_ok", "valid", "start",
         "sync_word", "n_err", "n_candidates", "n_dropped")


def _params(**kw):
    jp = J.LoraParams(**kw)
    return jp, T.params_from_reference(jp)


def _build_stream(jp, packets, length, seed=42, noise=0.05):
    """Noisy stream with framed packets: [(offset, payload bytes), ...]
    (tests/test_stream_frames.py:30-41)."""
    rng = np.random.default_rng(seed)
    sr = rng.standard_normal(length).astype(np.float32) * noise
    si = rng.standard_normal(length).astype(np.float32) * noise
    for g, payload in packets:
        sym = jframe.encode_frame(np.asarray(payload, np.uint8), jp)
        re, im = J.modulate(np.asarray(sym)[None], jp)
        n = np.asarray(re).shape[-1]
        sr[g:g + n] += np.asarray(re)[0]
        si[g:g + n] += np.asarray(im)[0]
    return sr, si


def _assert_frames_equal(tf, jf):
    assert type(tf).__name__ == "RecoveredFrames"
    assert tf._fields == jf._fields
    for f in EXACT:
        np.testing.assert_array_equal(getattr(tf, f).numpy(),
                                      np.asarray(getattr(jf, f)), err_msg=f)
    np.testing.assert_allclose(tf.cfo.numpy(), np.asarray(jf.cfo),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(tf.time_offset.numpy(),
                               np.asarray(jf.time_offset), atol=1e-3, rtol=0)


def _both(sr, si, jp, tp, tstate=None, jstate=None, **kw):
    kw.setdefault("max_payload_len", MAX_LEN)
    kw.setdefault("max_packets", 8)
    jres, jst = jrx.receive_stream_frames(jnp.asarray(sr), jnp.asarray(si),
                                          jp, state=jstate, **kw)
    tres, tst = trx.receive_stream_frames(torch.as_tensor(sr),
                                          torch.as_tensor(si), tp,
                                          state=tstate, **kw)
    _assert_frames_equal(tres, jres)
    np.testing.assert_array_equal(tst.tail_r.numpy(), np.asarray(jst.tail_r))
    np.testing.assert_array_equal(tst.tail_i.numpy(), np.asarray(jst.tail_i))
    assert int(tst.offset) == int(jst.offset)
    return (tres, tst), (jres, jst)


def _by_start(frames):
    out = {}
    for k in np.nonzero(frames.valid.numpy())[0]:
        if bool(frames.crc_ok[k]):
            ln = int(frames.length[k])
            out[int(frames.start[k])] = frames.payload[k, :ln].tolist()
    return out


@pytest.mark.parametrize("cr", ["4/8", "4/5"])
def test_mixed_length_frames_match_jax(cr):
    jp, tp = _params(sf=7, cr=cr)
    rng = np.random.default_rng(7)
    pkts = [(1000, rng.integers(0, 256, 3, dtype=np.uint8)),
            (9000, rng.integers(0, 256, 16, dtype=np.uint8)),
            (17003, rng.integers(0, 256, 9, dtype=np.uint8))]
    sr, si = _build_stream(jp, pkts, 24576)
    (tres, _), _ = _both(sr, si, jp, tp)
    got = _by_start(tres)
    assert got == {g: list(p) for g, p in pkts}
    good = tres.valid.numpy() & tres.crc_ok.numpy()
    assert tres.length.numpy()[good].tolist() == [3, 16, 9]
    assert tres.hdr_ok.numpy()[good].all()
    assert (tres.sync_word.numpy()[good] == 0x12).all()


def test_back_to_back_zero_gap_matches_jax():
    """The second frame starts where the first ends
    (tests/test_stream_frames.py:74-87)."""
    jp, tp = _params(sf=7, cr="4/8")
    rng = np.random.default_rng(3)
    p1 = rng.integers(0, 256, 6, dtype=np.uint8)
    p2 = rng.integers(0, 256, 11, dtype=np.uint8)
    len1 = trx.packet_samples(tp, T.frame_symbols(tp, 6))
    pkts = [(2048, p1), (2048 + len1, p2)]
    sr, si = _build_stream(jp, pkts, 24576)
    (tres, _), _ = _both(sr, si, jp, tp)
    assert _by_start(tres) == {2048: list(p1), 2048 + len1: list(p2)}


def test_chunked_matches_jax_and_single_shot():
    """Chunks of 4096 with carried state, a frame straddling a chunk
    boundary: each chunk equals the JAX package's chunk, and the frames
    equal the single call's (tests/test_stream_frames.py:122-142)."""
    jp, tp = _params(sf=7, cr="4/8")
    rng = np.random.default_rng(5)
    pkts = [(2000, rng.integers(0, 256, 5, dtype=np.uint8)),
            (6000, rng.integers(0, 256, 14, dtype=np.uint8)),
            (14000, rng.integers(0, 256, 8, dtype=np.uint8))]
    sr, si = _build_stream(jp, pkts, 24576)
    (whole, _), _ = _both(sr, si, jp, tp)
    want = _by_start(whole)
    assert want == {g: list(p) for g, p in pkts}
    tstate = T.stream_frames_init(tp, MAX_LEN, device="cpu")
    jstate = jrx.stream_frames_init(jp, MAX_LEN)
    np.testing.assert_array_equal(tstate.tail_r.numpy(),
                                  np.asarray(jstate.tail_r))
    got = {}
    for lo in range(0, 24576, 4096):
        (tres, tstate), (_, jstate) = _both(
            sr[lo:lo + 4096], si[lo:lo + 4096], jp, tp, tstate=tstate,
            jstate=jstate)
        got.update(_by_start(tres))
    assert got == want


def test_oversize_frame_and_saturation_match_jax():
    """A frame longer than the bound surfaces with hdr_ok False
    (tests/test_stream_frames.py:145-159); with max_packets below the
    frame count, the earliest win and n_dropped counts the rest."""
    jp, tp = _params(sf=7, cr="4/8")
    rng = np.random.default_rng(9)
    big = rng.integers(0, 256, MAX_LEN + 8, dtype=np.uint8)
    small = [rng.integers(0, 256, 4, dtype=np.uint8) for _ in range(3)]
    pkts = [(3000, big)] + [(16000 + 8000 * k, p) for k, p in
                            enumerate(small)]
    sr, si = _build_stream(jp, pkts, 40960)
    (tres, _), _ = _both(sr, si, jp, tp, max_packets=3)
    assert int(tres.n_candidates) == 4 and int(tres.n_dropped) == 1
    assert tres.valid.all()
    assert not bool(tres.hdr_ok[0]) and not bool(tres.crc_ok[0])
    assert _by_start(tres) == {16000: list(small[0]), 24000: list(small[1])}


@pytest.mark.parametrize("crc", [True, False])
def test_wide_sf9_bw250_frames_match_jax(crc):
    """sf9/BW250/CR4-8/osr2 frames through the injective wide receiver,
    with and without the payload CRC."""
    jp, tp = _params(sf=9, bw=250000, cr="4/8", osr=2)
    rng = np.random.default_rng(11)
    pkts = [(517, rng.integers(0, 256, 7, dtype=np.uint8)),
            (40003, rng.integers(0, 256, 12, dtype=np.uint8))]
    length = 98304
    srng = np.random.default_rng(4)
    sr = srng.standard_normal(length).astype(np.float32) * 0.05
    si = srng.standard_normal(length).astype(np.float32) * 0.05
    for g, pay in pkts:
        sym = jframe.encode_frame(pay, jp, crc=crc)
        re, im = J.modulate(np.asarray(sym)[None], jp)
        n = np.asarray(re).shape[-1]
        sr[g:g + n] += np.asarray(re)[0]
        si[g:g + n] += np.asarray(im)[0]
    (tres, _), _ = _both(sr, si, jp, tp, max_payload_len=12, crc=crc)
    good = tres.valid.numpy() & tres.crc_ok.numpy()
    assert tres.start.numpy()[good].tolist() == [g for g, _ in pkts]
    for k, (_, pay) in zip(np.nonzero(good)[0], pkts):
        assert int(tres.length[k]) == len(pay)
        assert tres.payload[k, :len(pay)].tolist() == list(pay)


def test_noise_only_recovers_nothing_and_rejects_ragged():
    jp, tp = _params(sf=7, cr="4/8")
    rng = np.random.default_rng(12)
    z = rng.standard_normal((2, 16384)).astype(np.float32) * 0.3
    (tres, _), _ = _both(z[0], z[1], jp, tp)
    assert not tres.valid.any() and int(tres.n_candidates) == 0
    with pytest.raises(ValueError, match="multiple of stride"):
        trx.receive_stream_frames(torch.zeros(1000), torch.zeros(1000), tp,
                                  max_payload_len=MAX_LEN, max_packets=4)
    with pytest.raises(terrors.InvalidArgumentError, match="one stream"):
        trx.receive_stream_frames(torch.zeros(2, 4096), torch.zeros(2, 4096),
                                  tp, max_payload_len=MAX_LEN, max_packets=4)
