"""The port's streaming front-end and streaming receiver against the JAX
package, on the CPU.

``stream_window_detect_ref`` (the plain version of kernel #7) is held to the
JAX package's jnp scan (``_scan_block(..., backend="jnp")``) and to its
Pallas stream kernel in interpret mode (sf <= 10), in the cases of
tests/test_pallas_stream.py; ``find_sync_starts``/``find_packet_starts`` are
fed the same ``StreamScan`` in both packages; ``receive_stream`` takes the
same streams as tests/test_receiver.py and tests/test_receiver_wide.py.
Inputs are made with numpy from fixed seeds and handed to both packages.

Tolerances: scan bins exact on every window with a clear peak (power -
noise > 3 dB; on noise the DFT orders may split near-ties) and dB within
0.05 (tests/test_pallas_stream.py:64-71); masks and starts exact; packets'
payload, crc_ok, valid, start, sync_word, n_candidates and n_dropped exact,
CFO within 1e-5 and timing within 1e-3 samples.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")

import torch  # noqa: E402

import lora_sdr_lightweight_standalone_library_clean_tpu as J  # noqa: E402
from lora_sdr_lightweight_standalone_library_clean_tpu.ops.pallas_stream import (  # noqa: E402
    stream_window_detect as j_stream_window_detect)
from lora_sdr_lightweight_standalone_library_clean_tpu.parallel import (  # noqa: E402
    receiver as jrx, streaming as jst)

import lora_sdr_lightweight_standalone_library_clean_tpu_torch as T  # noqa: E402
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.ops import (  # noqa: E402
    cuda_stream)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.parallel import (  # noqa: E402
    receiver as trx, streaming as tst)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.utils import (  # noqa: E402
    errors as terrors)

torch.set_num_threads(1)

DB_ATOL = 0.05


def _params(**kw):
    jp = J.LoraParams(**kw)
    return jp, T.params_from_reference(jp)


def _stream_with_packet(jp, n_sym, seed, amp=0.5):
    """Noise (sigma 0.05) with one packet of 8 bytes at sample 0
    (tests/test_pallas_stream.py:26-36)."""
    rng = np.random.default_rng(seed)
    total = jp.step * n_sym
    r = rng.standard_normal(total).astype(np.float32) * 0.05
    i = rng.standard_normal(total).astype(np.float32) * 0.05
    re, im = J.modulate(J.encode(np.arange(8, dtype=np.uint8)[None]), jp)
    cut = min(total, re.shape[-1])
    r[:cut] += amp * np.asarray(re)[0][:cut]
    i[:cut] += amp * np.asarray(im)[0][:cut]
    return r, i


def _assert_scan_close(got, want):
    gi, gp, ga = (np.asarray(a) for a in got)
    wi, wp, wa = (np.asarray(a) for a in want)
    assert gi.shape == wi.shape
    clear = (wp - wa) > 3.0
    assert clear.any()
    np.testing.assert_array_equal(gi[clear], wi[clear])
    np.testing.assert_allclose(gp, wp, atol=DB_ATOL, rtol=0)
    np.testing.assert_allclose(ga, wa, atol=DB_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# #7: the stream scan's plain version against the jnp scan and the kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sf,osr,stride_div", [
    (7, 1, 1), (7, 1, 4), (8, 1, 2), (9, 1, 4),
    (10, 1, 4), (12, 1, 4),
    (7, 2, 4), (8, 4, 4),
])
def test_stream_scan_matches_jax(sf, osr, stride_div):
    jp, tp = _params(sf=sf, osr=osr)
    stride = jp.step // stride_div
    r, i = _stream_with_packet(jp, 21 if sf >= 10 else 37, seed=sf)
    windows = r.shape[-1] // stride
    got = cuda_stream.stream_window_detect_ref(
        torch.as_tensor(r), torch.as_tensor(i), tp, stride, windows)
    # the port's scan reads zeros past the stream, the JAX halo of zeros
    halo = jnp.zeros(jp.step, jnp.float32)
    want = jst._scan_block(jnp.asarray(r), jnp.asarray(i), halo, halo, jp,
                           stride, backend="jnp")
    _assert_scan_close(got, want)
    scan = T.streaming.stream_scan(torch.as_tensor(r), torch.as_tensor(i),
                                   tp, stride=stride)
    for a, b in zip(scan, got):
        assert torch.equal(a, b)
    if sf <= 10:
        ext_r = jnp.concatenate([jnp.asarray(r), halo])
        ext_i = jnp.concatenate([jnp.asarray(i), halo])
        kern = j_stream_window_detect(ext_r, ext_i, jp, stride, windows,
                                      interpret=True)
        _assert_scan_close(got, kern)


@pytest.mark.parametrize("sf,osr", [(7, 1), (8, 2)])
def test_stream_scan_custom_multiplier_matches_jax(sf, osr):
    """A caller's ``dcr``/``dci`` (here the scan down-chirp times a tone of
    5 bins) replaces the scan down-chirp in both packages, and moves every
    clear window's bin by 5."""
    jp, tp = _params(sf=sf, osr=osr)
    stride = jp.step // 4
    r, i = _stream_with_packet(jp, 29, seed=60 + sf)
    windows = r.shape[-1] // stride
    dc = np.asarray(jst._scan_downchirp(jp)[0]) \
        + 1j * np.asarray(jst._scan_downchirp(jp)[1])
    dc = dc * np.exp(2j * np.pi * 5 * np.arange(jp.n) / jp.n)
    dcr, dci = dc.real.astype(np.float32), dc.imag.astype(np.float32)
    got = cuda_stream.stream_window_detect_ref(
        torch.as_tensor(r), torch.as_tensor(i), tp, stride, windows,
        torch.as_tensor(dcr), torch.as_tensor(dci))
    halo = jnp.zeros(jp.step, jnp.float32)
    want = j_stream_window_detect(
        jnp.concatenate([jnp.asarray(r), halo]),
        jnp.concatenate([jnp.asarray(i), halo]), jp, stride, windows,
        dcr, dci, interpret=True)
    _assert_scan_close(got, want)
    plain = cuda_stream.stream_window_detect_ref(
        torch.as_tensor(r), torch.as_tensor(i), tp, stride, windows)
    clear = (plain[1] - plain[2]) > 3.0
    assert torch.equal(got[0][clear], (plain[0][clear] + 5) % jp.n)


def test_stream_scan_short_stream_padding():
    """Windows that run past a short stream read zeros
    (tests/test_pallas_stream.py:100-114), and windows wholly past it give
    -inf dB, as the JAX package's padding does."""
    jp, tp = _params(sf=7)
    stride = jp.step
    r, i = _stream_with_packet(jp, 5, seed=3, amp=1.0)
    halo = jnp.zeros(jp.step, jnp.float32)
    want = jst._scan_block(jnp.asarray(r), jnp.asarray(i), halo, halo, jp,
                           stride, backend="jnp")
    got = cuda_stream.stream_window_detect_ref(
        torch.as_tensor(r), torch.as_tensor(i), tp, stride, 5)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=DB_ATOL)
    past = cuda_stream.stream_window_detect_ref(
        torch.as_tensor(r), torch.as_tensor(i), tp, stride, 7)
    assert torch.equal(past[0][:5], got[0])
    assert past[0][5:].tolist() == [0, 0]
    assert bool(torch.isneginf(past[1][5:]).all())
    assert bool(torch.isneginf(past[2][5:]).all())


def test_stream_scan_batch_of_streams():
    """Leading axes are independent streams: a (2, 3) batch gives each
    stream's own scan."""
    jp, tp = _params(sf=7, osr=2)
    stride = jp.step // 4
    planes = [_stream_with_packet(jp, 9, seed=40 + k) for k in range(6)]
    r = np.stack([p[0] for p in planes]).reshape(2, 3, -1)
    i = np.stack([p[1] for p in planes]).reshape(2, 3, -1)
    got = tst.stream_scan(torch.as_tensor(r), torch.as_tensor(i), tp,
                          stride=stride)
    assert got.index.shape == (2, 3, r.shape[-1] // stride)
    for a in range(2):
        for b in range(3):
            one = tst.stream_scan(torch.as_tensor(r[a, b]),
                                  torch.as_tensor(i[a, b]), tp,
                                  stride=stride)
            assert torch.equal(got.index[a, b], one.index)
            torch.testing.assert_close(got.power[a, b], one.power)


def test_stream_scan_rejects_ragged_length():
    _, tp = _params(sf=7)
    z = torch.zeros(1000)
    with pytest.raises(ValueError, match="multiple of stride"):
        tst.stream_scan(z, z, tp, stride=128)


# ---------------------------------------------------------------------------
# Start finders on the same StreamScan
# ---------------------------------------------------------------------------

def _synthetic_scan(jp, windows, hop, seed):
    """A StreamScan with planted sync pairs at misalignments of both signs
    (d = -n/2+1 ... n/2), runs of neighbouring flags (the dedupe rule),
    weak windows, and dead windows (-inf on both dB values)."""
    rng = np.random.default_rng(seed)
    n, bs = jp.n, jp.bw_scale
    sw0, sw1 = jp.sync_nibble_symbols()
    idx = rng.integers(0, n, windows).astype(np.int32)
    power = rng.normal(-14.0, 3.0, windows).astype(np.float32)
    pav = rng.normal(0.0, 1.0, windows).astype(np.float32)
    for w in range(0, windows - hop - 3, 17):
        d = int(rng.integers(-n // 2 + 1, n // 2 + 1))
        for k in range(int(rng.integers(1, 4))):    # neighbouring flags
            shift = d - k * int(rng.integers(0, 3))
            idx[w + k] = (sw0 * bs + shift) % n
            idx[w + k + hop] = (sw1 * bs + shift) % n
            power[[w + k, w + k + hop]] = rng.uniform(3.0, 30.0)
    dead = rng.choice(windows, windows // 10, replace=False)
    power[dead] = -np.inf
    pav[dead] = -np.inf
    return idx, power, pav


@pytest.mark.parametrize("sf,bw,osr,stride_div,max_mis", [
    (7, 125000, 1, 4, None), (7, 125000, 1, 1, None),
    (8, 125000, 2, 4, None), (9, 250000, 2, 8, 40),
    (8, 500000, 4, 16, 24), (6, 250000, 1, 4, 3)])
def test_start_finders_match_jax(sf, bw, osr, stride_div, max_mis):
    jp, tp = _params(sf=sf, bw=bw, osr=osr)
    stride = jp.step // stride_div
    hop = jp.step // stride
    idx, power, pav = _synthetic_scan(jp, 600, hop, seed=sf * 7 + osr)
    jscan = jst.StreamScan(jnp.asarray(idx), jnp.asarray(power),
                           jnp.asarray(pav))
    tscan = tst.StreamScan(torch.as_tensor(idx), torch.as_tensor(power),
                           torch.as_tensor(pav))
    for tol in (2, 4):
        jk, js = jst.find_packet_starts(jscan, jp, stride=stride,
                                        dedupe_tol=tol, max_mis=max_mis)
        tk, ts = tst.find_packet_starts(tscan, tp, stride=stride,
                                        dedupe_tol=tol, max_mis=max_mis)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        assert tk.any() and (ts < torch.arange(600) * stride).any()
    for gate in (3.0, 10.0):
        jm = jst.find_sync_starts(jscan, jp, power_gate_db=gate,
                                  stride=stride)
        tm = tst.find_sync_starts(tscan, tp, power_gate_db=gate,
                                  stride=stride)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("sf,stride_div", [(7, 4), (8, 1)])
def test_start_finders_on_a_real_scan(sf, stride_div):
    """The JAX package's scan of a stream holding an aligned packet,
    converted, through both packages' start finders."""
    jp, tp = _params(sf=sf)
    stride = jp.step // stride_div
    r, i = _stream_with_packet(jp, 37, seed=11, amp=1.0)
    jscan = jst.stream_scan(jnp.asarray(r), jnp.asarray(i), jp,
                            stride=stride, backend="jnp")
    tscan = tst.StreamScan(*(torch.as_tensor(np.array(a)) for a in jscan))
    jk, js = jst.find_packet_starts(jscan, jp, stride=stride)
    tk, ts = tst.find_packet_starts(tscan, tp, stride=stride)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert int(tk.sum()) >= 1
    jm = jst.find_sync_starts(jscan, jp, stride=stride)
    tm = tst.find_sync_starts(tscan, tp, stride=stride)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert bool(tm[0])


# ---------------------------------------------------------------------------
# receive_stream against the JAX package's
# ---------------------------------------------------------------------------

def _crc_frame(body):
    b = np.asarray(body, np.uint8)
    crc = int(np.asarray(J.crc_sx1272(jnp.asarray(b[2:]))))
    return np.concatenate([b, [crc & 0xFF, crc >> 8]]).astype(np.uint8)


def _build_stream(jp, offsets, payload_bytes, length, seed=42, noise=0.05,
                  cfo_bins=0.0, bad=()):
    """Noisy stream with one CRC-framed packet per offset
    (tests/test_receiver_wide.py:41-62); packets listed in ``bad`` have a
    byte changed after their CRC."""
    rng = np.random.default_rng(seed)
    plen = jrx.packet_samples(jp, payload_bytes * 2)
    sr = rng.standard_normal(length).astype(np.float32) * noise
    si = rng.standard_normal(length).astype(np.float32) * noise
    payloads = []
    for k, g in enumerate(offsets):
        pl = _crc_frame(rng.integers(0, 256, payload_bytes - 2))
        if k in bad:
            pl[3] ^= 0x41
        payloads.append(pl)
        re, im = J.modulate(J.encode(pl[None]), jp)
        sr[g:g + plen] += np.asarray(re)[0]
        si[g:g + plen] += np.asarray(im)[0]
    if cfo_bins:
        ph = (2.0 * np.pi * cfo_bins / (jp.n * jp.osr) * np.arange(length))
        c, s = np.cos(ph, dtype=np.float32), np.sin(ph, dtype=np.float32)
        sr, si = sr * c - si * s, sr * s + si * c
    return sr, si, payloads


EXACT = ("payload", "crc_ok", "valid", "start", "sync_word", "n_candidates",
         "n_dropped")


def _assert_packets_equal(tp_, jp_):
    for f in EXACT:
        np.testing.assert_array_equal(getattr(tp_, f).numpy(),
                                      np.asarray(getattr(jp_, f)), err_msg=f)
    np.testing.assert_allclose(tp_.cfo.numpy(), np.asarray(jp_.cfo),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(tp_.time_offset.numpy(),
                               np.asarray(jp_.time_offset), atol=1e-3,
                               rtol=0)


def _both(sr, si, jp, tp, **kw):
    jres, jst_ = jrx.receive_stream(jnp.asarray(sr), jnp.asarray(si), jp,
                                    **kw)
    tres, tst_ = trx.receive_stream(torch.as_tensor(sr), torch.as_tensor(si),
                                    tp, **kw)
    return (tres, tst_), (jres, jst_)


def test_receive_stream_arbitrary_offsets_match_jax():
    jp, tp = _params(sf=7)
    offsets = [512, 5003, 9000, 11777]     # aligned and sub-stride offsets
    sr, si, payloads = _build_stream(jp, offsets, 8, 16384, bad=(2,))
    (tres, tstate), (jres, jstate) = _both(sr, si, jp, tp,
                                           payload_symbols=16, max_packets=8)
    _assert_packets_equal(tres, jres)
    valid = tres.valid.numpy()
    assert valid.sum() == 4
    assert tres.start.numpy()[valid].tolist() == offsets
    for k in range(4):
        np.testing.assert_array_equal(tres.payload.numpy()[k], payloads[k])
    assert tres.crc_ok.numpy()[:4].tolist() == [True, True, False, True]
    assert (tres.sync_word.numpy()[valid] == 0x12).all()
    np.testing.assert_array_equal(tstate.tail_r.numpy(),
                                  np.asarray(jstate.tail_r))
    assert int(tstate.offset) == int(jstate.offset) == 16384


def test_receive_stream_chunked_matches_jax_and_single_shot():
    """Chunks of 4096 with carried state, a packet straddling a chunk
    boundary: each chunk equals the JAX package's chunk, and the packets
    equal the single call's."""
    jp, tp = _params(sf=7)
    plen = trx.packet_samples(tp, 16)
    offsets = [512, 8192 - plen // 2, 13056]
    sr, si, _ = _build_stream(jp, offsets, 8, 16384)
    whole, _ = trx.receive_stream(torch.as_tensor(sr), torch.as_tensor(si),
                                  tp, payload_symbols=16, max_packets=8)
    tstate = trx.stream_rx_init(tp, 16, device="cpu")
    jstate = jrx.stream_rx_init(jp, 16)
    got = []
    for lo in range(0, 16384, 4096):
        part = (sr[lo:lo + 4096], si[lo:lo + 4096])
        tres, tstate = trx.receive_stream(
            *(torch.as_tensor(a) for a in part), tp, payload_symbols=16,
            max_packets=8, state=tstate)
        jres, jstate = jrx.receive_stream(
            *(jnp.asarray(a) for a in part), jp, payload_symbols=16,
            max_packets=8, state=jstate)
        _assert_packets_equal(tres, jres)
        for k in np.nonzero(tres.valid.numpy())[0]:
            got.append((int(tres.start[k]), bytes(tres.payload[k].numpy()),
                        bool(tres.crc_ok[k])))
    want = sorted((int(whole.start[k]), bytes(whole.payload[k].numpy()),
                   bool(whole.crc_ok[k]))
                  for k in np.nonzero(whole.valid.numpy())[0])
    assert sorted(got) == want
    assert [g[0] for g in sorted(got)] == offsets


def test_receive_stream_saturated_chunk_matches_jax():
    """More packets than max_packets: the earliest win, and n_dropped
    counts the rest."""
    jp, tp = _params(sf=7)
    offsets = [2560 * k + 37 * k for k in range(6)]
    sr, si, payloads = _build_stream(jp, offsets, 8, 16384)
    (tres, _), (jres, _) = _both(sr, si, jp, tp, payload_symbols=16,
                                 max_packets=3)
    _assert_packets_equal(tres, jres)
    assert int(tres.n_candidates) == 6 and int(tres.n_dropped) == 3
    assert tres.start.tolist() == offsets[:3]
    for k in range(3):
        np.testing.assert_array_equal(tres.payload.numpy()[k], payloads[k])


def test_receive_stream_wide_sf9_bw250_matches_jax():
    """The wide sf9/BW250/osr2 stream under AWGN and CFO
    (tests/test_receiver_wide.py:78-84), through demodulate_wide."""
    jp, tp = _params(sf=9, bw=250000, cr="4/8", osr=2)
    offsets = [517, 23003, 46101]
    sr, si, payloads = _build_stream(jp, offsets, 8, 65536, cfo_bins=0.2)
    (tres, _), (jres, _) = _both(sr, si, jp, tp, payload_symbols=16,
                                 max_packets=8)
    _assert_packets_equal(tres, jres)
    valid = tres.valid.numpy()
    assert tres.start.numpy()[valid].tolist() == offsets
    for k in range(3):
        np.testing.assert_array_equal(tres.payload.numpy()[k], payloads[k])
    assert tres.crc_ok.numpy()[valid].all()


def test_receive_stream_noise_only_recovers_nothing():
    jp, tp = _params(sf=7)
    rng = np.random.default_rng(7)
    z = rng.standard_normal((2, 8192)).astype(np.float32) * 0.3
    (tres, _), (jres, _) = _both(z[0], z[1], jp, tp, payload_symbols=16,
                                 max_packets=8)
    _assert_packets_equal(tres, jres)
    assert not tres.valid.any()


def _midway_stream(jp, count, seed):
    """``count`` sf7 packets, each starting midway between two step/4
    scan windows (16 samples off the 32-sample stride grid), under AWGN
    sigma 0.05."""
    plen = jrx.packet_samples(jp, 16)
    spacing = plen + 2 * jp.step
    offsets = [k * spacing + jp.step + jp.step // 8 for k in range(count)]
    length = -(-(count * spacing + 2 * jp.step) // jp.step) * jp.step
    sr, si, payloads = _build_stream(jp, offsets, 8, length, seed=seed)
    return sr, si, payloads, offsets


def test_receive_stream_default_gate_misses_midway_starts_like_jax():
    """At the default stride step/4, a start midway between two windows
    leaves the nearest window 16 samples into a neighbouring symbol, and its
    power over the other bins sits near 5 dB (112^2 against the leaked rest
    of the 128-sample window).  Under sigma 0.05 the default 5 dB gate then
    misses some such packets, in the JAX package and in the port alike; a
    4 dB gate recovers every one at its planted start."""
    jp, tp = _params(sf=7)
    sr, si, payloads, offsets = _midway_stream(jp, 16, seed=0)
    kw = {"payload_symbols": 16, "max_packets": 16}
    (t5, _), (j5, _) = _both(sr, si, jp, tp, **kw)
    _assert_packets_equal(t5, j5)
    found5 = t5.start.numpy()[t5.valid.numpy()].tolist()
    assert 0 < len(found5) < len(offsets)
    assert set(found5) < set(offsets)
    (t4, _), (j4, _) = _both(sr, si, jp, tp, power_gate_db=4.0, **kw)
    _assert_packets_equal(t4, j4)
    assert int(t4.n_candidates) == 16 and int(t4.n_dropped) == 0
    assert t4.start.tolist() == offsets
    for k in range(16):
        np.testing.assert_array_equal(t4.payload.numpy()[k], payloads[k])
    assert t4.crc_ok.all()


def test_receive_stream_noise_only_flags_nothing_at_4db():
    """Noise alone (sigma 0.05, 8192 step/4 windows) gives no candidate at
    a 4 dB gate in either package."""
    jp, tp = _params(sf=7)
    rng = np.random.default_rng(8)
    z = rng.standard_normal((2, 8192 * 32)).astype(np.float32) * 0.05
    (tres, _), (jres, _) = _both(z[0], z[1], jp, tp, payload_symbols=16,
                                 max_packets=8, power_gate_db=4.0)
    _assert_packets_equal(tres, jres)
    assert int(tres.n_candidates) == 0 and not tres.valid.any()


def test_receive_stream_rejects_what_it_does_not_take():
    _, tp = _params(sf=9, bw=250000, osr=1)
    z = torch.zeros(8192)
    with pytest.raises(terrors.InvalidArgumentError):
        trx.receive_stream(z, z, tp, payload_symbols=8, max_packets=4,
                           wide=True)
    _, tp7 = _params(sf=7)
    with pytest.raises(terrors.InvalidArgumentError, match="one stream"):
        trx.receive_stream(z.reshape(2, -1), z.reshape(2, -1), tp7,
                           payload_symbols=8, max_packets=4)
    with pytest.raises(ValueError, match="multiple of stride"):
        trx.receive_stream(z[:1000], z[:1000], tp7, payload_symbols=8,
                           max_packets=4)
