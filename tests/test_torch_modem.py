"""The port's plain modules against the JAX package, function by function:
host constant tables (bit-equal), config, codec, chirp synthesis, DFT,
detection, window extraction and the CFO/timing estimator.

Inputs are made with numpy from fixed seeds and handed to both packages.
Each comparison states its tolerance: integers, bytes and host tables are
exact; float32 results differ by summation order (XLA and PyTorch CPU
matmuls, sin/cos implementations).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")

import torch  # noqa: E402

import lora_sdr_lightweight_standalone_library_clean_tpu as J  # noqa: E402
from lora_sdr_lightweight_standalone_library_clean_tpu.models import (  # noqa: E402
    modem as jmodem)
from lora_sdr_lightweight_standalone_library_clean_tpu.ops import (  # noqa: E402
    chirp as jchirp, codes as jcodes, detect as jdetect, dft as jdft)
from lora_sdr_lightweight_standalone_library_clean_tpu.utils import (  # noqa: E402
    config as jconfig, errors as jerrors)

import lora_sdr_lightweight_standalone_library_clean_tpu_torch as T  # noqa: E402
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.models import (  # noqa: E402
    modem as tmodem)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.ops import (  # noqa: E402
    chirp as tchirp, codes as tcodes, detect as tdetect, dft as tdft)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.utils import (  # noqa: E402
    config as tconfig, errors as terrors)

torch.set_num_threads(1)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bit_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# Host constant tables: bit-equal to the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [16, 128, 256, 512])
def test_dft_mats_bit_equal(n):
    for a, b in zip(tdft._dft_mats(n), jdft._dft_mats(n)):
        _bit_equal(a, b)


def test_dft_twiddles_and_factors_bit_equal():
    for n in (1024, 2048, 4096):
        assert tdft.dft_factors(n) == jdft.dft_factors(n)
        n1, n2 = tdft.dft_factors(n)
        for a, b in zip(tdft._twiddle(n1, n2), jdft._twiddle(n1, n2)):
            _bit_equal(a, b)


@pytest.mark.parametrize("n", [128, 256, 512])
def test_tx_tone_tables_bit_equal(n):
    for a, b in zip(tchirp._tx_tone_tables(n), jchirp._tx_tone_tables(n)):
        _bit_equal(a, b)


@pytest.mark.parametrize("n,bs", [(128, 1), (256, 1), (512, 2), (128, 4),
                                  (4096, 4)])
def test_tx_base_chirp_bit_equal(n, bs):
    for a, b in zip(tchirp._tx_base_chirp(n, bs), jchirp._tx_base_chirp(n, bs)):
        _bit_equal(a, b)


def test_tx_tone_tables_factored_bit_equal():
    """The digit tables at every factored size, and the factored kernel's
    layout of them (w2 columns rolled by -1, ``pallas_tx.py:259-260``)."""
    from lora_sdr_lightweight_standalone_library_clean_tpu_torch.ops import (
        cuda_tx)
    for n in (1024, 2048, 4096):
        jt = jchirp._tx_tone_tables_factored(n, 128)
        for a, b in zip(tchirp._tx_tone_tables_factored(n, 128), jt):
            _bit_equal(a, b)
        want = (jt[0], jt[1], np.roll(jt[2], -1, axis=1),
                np.roll(jt[3], -1, axis=1))
        for a, b in zip(cuda_tx._tx_digit_tables(n), want):
            _bit_equal(a, b)


@pytest.mark.parametrize("sf,bs,osr", [(7, 1, 1), (8, 1, 1), (9, 2, 1),
                                       (7, 1, 2), (12, 4, 4)])
def test_downchirp_bit_equal(sf, bs, osr):
    for a, b in zip(tchirp.downchirp_ri(sf, bs, osr),
                    jchirp.downchirp_ri(sf, bs, osr)):
        _bit_equal(a, b)


@pytest.mark.parametrize("n", [128, 512])
def test_window_table_bit_equal(n):
    _bit_equal(tmodem.window_table(n, tconfig.Window.HANN),
               jmodem.window_table(n, jconfig.Window.HANN))
    assert tmodem.window_table(n, tconfig.Window.NONE) is None


@pytest.mark.parametrize("n", [0, 1, 4, 28, 60])
def test_crc_tables_bit_equal(n):
    if n:
        _bit_equal(tmodem._crc_bit_matrix(n), jmodem._crc_bit_matrix(n))
    _bit_equal(tmodem._crc_position_tables(n), jmodem._crc_position_tables(n))
    assert tcodes.crc_mask_pair(n) == jcodes.crc_mask_pair(n)


def test_crc16_and_lfsr_tables_bit_equal():
    _bit_equal(tcodes.crc16_table(), jcodes.crc16_table())
    _bit_equal(tcodes._v_lfsr_sequence(5000), jcodes._v_lfsr_sequence(5000))
    assert tcodes.crc_mask_pair(5000) == jcodes.crc_mask_pair(5000)


# ---------------------------------------------------------------------------
# Config and errors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("profile", jconfig.STOCK_PROFILES,
                         ids=lambda p: p["name"])
def test_params_from_reference_round_trips_stock_profiles(profile):
    for kw in (dict(), dict(osr=2, window=jconfig.Window.HANN,
                            sync_word=0x34)):
        jp = jconfig.params_from_profile(profile, **kw)
        tp = tconfig.params_from_reference(jp)
        for field in ("sf", "bw", "cr", "osr", "sync_word", "n", "step",
                      "bw_scale", "rdd"):
            assert getattr(tp, field) == getattr(jp, field), field
        assert tp.window.value == jp.window.value
        assert tp.sync_nibble_symbols() == jp.sync_nibble_symbols()
        assert tp == T.params_from_profile(
            profile, osr=jp.osr, window=jp.window.value,
            sync_word=jp.sync_word)
        assert tconfig.params_from_reference(tp) == tp


def test_profiles_file_matches_stock_profiles():
    loaded = tconfig.load_profiles(tconfig.PROFILES_PATH)
    assert loaded == jconfig.load_profiles(jconfig.PROFILES_PATH)
    assert [p["name"] for p in loaded] == [
        p["name"] for p in tconfig.STOCK_PROFILES]
    assert tconfig.STOCK_PROFILES == jconfig.STOCK_PROFILES


def test_params_validation_matches():
    for bad in (dict(sf=13), dict(bw=100000), dict(osr=0)):
        with pytest.raises(ValueError):
            jconfig.LoraParams(**bad)
        with pytest.raises(ValueError):
            tconfig.LoraParams(**bad)


def test_errors_mirror_errno_contract():
    for name in ("InvalidArgumentError", "RangeError", "NoMemoryError",
                 "MicMismatchError"):
        te, je = getattr(terrors, name), getattr(jerrors, name)
        assert te.errno == je.errno
        assert issubclass(te, terrors.LoraError) and issubclass(te, ValueError)
    assert terrors.RangeError("x", errno=5).errno == 5


# ---------------------------------------------------------------------------
# Codec: exact over all byte values
# ---------------------------------------------------------------------------

def test_encode_all_bytes():
    b = np.arange(256, dtype=np.uint8).reshape(4, 64)
    np.testing.assert_array_equal(_np(T.encode(torch.as_tensor(b))),
                                  np.asarray(J.encode(b)).astype(np.int32))


def test_decode_all_codewords_and_single_bit_errors():
    """Every 8-bit codeword pair, then every codeword with each single bit
    flipped (Hamming corrects it)."""
    cw = np.arange(256, dtype=np.int32).reshape(8, 32)
    for syms in (cw, np.asarray(J.encode(np.arange(256, dtype=np.uint8)
                                         .reshape(2, 128))).astype(np.int32)):
        tp, tok = T.decode(torch.as_tensor(syms))
        jp, jok = J.decode(syms)
        np.testing.assert_array_equal(_np(tp), np.asarray(jp))
        np.testing.assert_array_equal(_np(tok), np.asarray(jok))
    enc = np.asarray(J.encode(np.arange(256, dtype=np.uint8)[None]))
    for bit in range(8):
        flipped = (enc.astype(np.int32) ^ (1 << bit))
        tp, _ = T.decode(torch.as_tensor(flipped), check_crc=False)
        jp, _ = J.decode(flipped, check_crc=False)
        np.testing.assert_array_equal(_np(tp), np.asarray(jp))


def test_decode_odd_symbol_count_raises():
    with pytest.raises(terrors.InvalidArgumentError):
        T.decode(torch.zeros((1, 3), dtype=torch.int32))


def test_crc_all_byte_values():
    """One-byte messages of every value, and each value at every position
    of a 28-byte message: exact against the JAX matmul CRC and the
    reference's sequential loop."""
    b = np.arange(256, dtype=np.uint8)[:, None]
    got = _np(T.crc_sx1272(torch.as_tensor(b)))
    np.testing.assert_array_equal(got, np.asarray(J.crc_sx1272(b)))
    assert all(int(got[v]) == jcodes.sx1272_data_checksum(b[v])
               for v in range(256))
    rng = np.random.default_rng(0)
    msgs = rng.integers(0, 256, (256, 28)).astype(np.uint8)
    msgs[np.arange(256), np.arange(256) % 28] = np.arange(256)
    np.testing.assert_array_equal(_np(T.crc_sx1272(torch.as_tensor(msgs))),
                                  np.asarray(J.crc_sx1272(msgs)))


@pytest.mark.parametrize("length", [0, 1, 2, 5, 17, 60])
def test_crc_lengths(length):
    rng = np.random.default_rng(length)
    msgs = rng.integers(0, 256, (8, length)).astype(np.uint8)
    got = _np(T.crc_sx1272(torch.as_tensor(msgs)))
    np.testing.assert_array_equal(got, np.asarray(J.crc_sx1272(msgs)))
    assert int(got[0]) == jcodes.sx1272_data_checksum(msgs[0])


def test_decode_crc_verdict_matches():
    rng = np.random.default_rng(3)
    pay = rng.integers(0, 256, (16, 12)).astype(np.uint8)
    crc = np.asarray(J.crc_sx1272(pay[:, 2:10])).astype(np.int64)
    pay[:, 10] = crc & 0xFF
    pay[:, 11] = crc >> 8
    pay[::3, 5] ^= 0x40
    syms = np.asarray(J.encode(pay)).astype(np.int32)
    tp, tok = T.decode(torch.as_tensor(syms))
    jp, jok = J.decode(syms)
    np.testing.assert_array_equal(_np(tp), pay)
    np.testing.assert_array_equal(_np(tok), np.asarray(jok))
    assert _np(tok).sum() == 16 - len(range(0, 16, 3))


# ---------------------------------------------------------------------------
# Chirp synthesis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,osr,bs", [(128, 1, 1), (128, 2, 2), (512, 4, 4)])
def test_chirp_phase_numerators_exact(n, osr, bs):
    rng = np.random.default_rng(n + osr)
    syms = rng.integers(0, 2 * n, (3, 5)).astype(np.int32)
    tn, td = tchirp.chirp_phase_numerators(torch.as_tensor(syms), n, osr, bs)
    jn, jd = jchirp.chirp_phase_numerators(syms, n, osr, bs)
    np.testing.assert_array_equal(_np(tn), np.asarray(jn))
    np.testing.assert_array_equal(_np(td), np.asarray(jd))
    mod = 2 * n * osr * osr
    np.testing.assert_array_equal(
        _np(tchirp.exact_prefix_sum_mod(td, mod)),
        np.asarray(jchirp.exact_prefix_sum_mod(jd, mod)))


@pytest.mark.parametrize("sf,bw,osr", [(7, 125000, 1), (8, 250000, 2),
                                       (7, 125000, 4)])
def test_modulate_vpu_matches_jax(sf, bw, osr):
    """Closed-form phases: the same float32 phase, sin/cos from two
    libraries -> within 2e-6."""
    rng = np.random.default_rng(sf)
    syms = rng.integers(0, 256, (3, 6)).astype(np.uint16)
    jp = J.LoraParams(sf=sf, bw=bw, osr=osr)
    tp = T.LoraParams(sf=sf, bw=bw, osr=osr)
    wr, wi = jchirp.modulate_ri(syms, jp, 0.5, method="vpu")
    gr, gi = tchirp._modulate_ri_vpu(torch.as_tensor(syms.astype(np.int32)),
                                     tp, 0.5)
    np.testing.assert_allclose(_np(gr), np.asarray(wr), atol=2e-6, rtol=0)
    np.testing.assert_allclose(_np(gi), np.asarray(wi), atol=2e-6, rtol=0)


@pytest.mark.parametrize("sf,bw", [(7, 125000), (9, 250000), (10, 125000)])
def test_modulate_mxu_matches_jax(sf, bw):
    """Tone tables: row lookup against the one-hot matmul -> within 2e-6
    (sf10 exercises the factored two-digit tables)."""
    rng = np.random.default_rng(sf)
    syms = rng.integers(0, 1 << sf, (3, 6)).astype(np.uint16)
    jp = J.LoraParams(sf=sf, bw=bw)
    tp = T.LoraParams(sf=sf, bw=bw)
    wr, wi = jchirp.modulate_ri(syms, jp, 0.75, method="mxu")
    tsyms = torch.as_tensor(syms.astype(np.int32))
    gr, gi = tchirp._modulate_ri_mxu(tsyms, tp, 0.75)
    np.testing.assert_allclose(_np(gr), np.asarray(wr), atol=2e-6, rtol=0)
    np.testing.assert_allclose(_np(gi), np.asarray(wi), atol=2e-6, rtol=0)
    # the public entry point takes the same plain form on a CPU input
    pr, pi = tchirp.modulate_ri(tsyms, tp, 0.75)
    assert torch.equal(pr, gr) and torch.equal(pi, gi)


def test_modulate_mxu_and_vpu_agree():
    """The two plain forms are float32 roundings of one exact phase."""
    syms = torch.as_tensor(np.random.default_rng(1).integers(0, 256, (2, 8)))
    p = T.LoraParams(sf=8)
    a = tchirp._modulate_ri_mxu(syms, p)
    b = tchirp._modulate_ri_vpu(syms, p)
    for x, y in zip(a, b):
        np.testing.assert_allclose(_np(x), _np(y), atol=2e-5, rtol=0)


@pytest.mark.parametrize("sf,bw,osr", [(7, 125000, 1), (9, 250000, 2)])
def test_dechirp_matches_jax(sf, bw, osr):
    rng = np.random.default_rng(sf)
    jp = J.LoraParams(sf=sf, bw=bw, osr=osr)
    tp = T.LoraParams(sf=sf, bw=bw, osr=osr)
    re = rng.standard_normal((2, 5 * jp.step)).astype(np.float32)
    im = rng.standard_normal((2, 5 * jp.step)).astype(np.float32)
    wr, wi = J.dechirp(re, im, jp)
    gr, gi = T.dechirp(torch.as_tensor(re), torch.as_tensor(im), tp)
    np.testing.assert_allclose(_np(gr), np.asarray(wr), atol=1e-6, rtol=0)
    np.testing.assert_allclose(_np(gi), np.asarray(wi), atol=1e-6, rtol=0)


def test_complex_helpers_round_trip():
    rng = np.random.default_rng(2)
    iq = (rng.standard_normal(64) + 1j * rng.standard_normal(64)).astype(
        np.complex64)
    re, im = T.from_complex(iq, device="cpu")
    assert re.dtype == torch.float32 and re.device.type == "cpu"
    np.testing.assert_array_equal(T.to_complex(re, im), iq)


def test_host_data_goes_to_the_card():
    """Host data (numpy, lists) and ``from_complex`` run on the CUDA card
    unless the caller asks for the CPU; without a card they raise, saying
    so, instead of running on the CPU.  A CPU tensor stays on the CPU."""
    iq = np.ones(8, np.complex64)
    b = np.arange(4, dtype=np.uint8)[None]
    assert T.encode(torch.as_tensor(b)).device.type == "cpu"
    if torch.cuda.is_available():
        assert T.encode(b).device.type == "cuda"
        assert T.from_complex(iq)[0].device.type == "cuda"
        return
    for call in (lambda: T.encode(b), lambda: T.decode([[0, 0]]),
                 lambda: T.crc_sx1272(b), lambda: T.from_complex(iq),
                 lambda: T.modulate(b, T.LoraParams(sf=7))):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()


# ---------------------------------------------------------------------------
# DFT and detection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,method", [(128, "direct"), (512, "direct"),
                                      (1024, "factored"), (256, "factored")])
def test_dft_matches_jax(n, method):
    """float32 DFT of unit-variance input, relative to its peak: 1e-5."""
    rng = np.random.default_rng(n)
    zr = rng.standard_normal((3, n)).astype(np.float32)
    zi = rng.standard_normal((3, n)).astype(np.float32)
    jr, ji = jdft.dft_ri(jnp.asarray(zr), jnp.asarray(zi), method=method)
    tr, ti = tdft.dft_ri(torch.as_tensor(zr), torch.as_tensor(zi),
                         method=method)
    scale = float(np.abs(np.asarray(jr)).max())
    np.testing.assert_allclose(_np(tr), np.asarray(jr), atol=1e-5 * scale,
                               rtol=0)
    np.testing.assert_allclose(_np(ti), np.asarray(ji), atol=1e-5 * scale,
                               rtol=0)
    # and both agree with numpy's FFT
    want = np.fft.fft(zr.astype(np.float64) + 1j * zi.astype(np.float64))
    np.testing.assert_allclose(_np(tr), want.real, atol=1e-4 * scale, rtol=0)


@pytest.mark.parametrize("sf", [7, 8, 9])
def test_detect_matches_jax(sf):
    """Tones at known bins plus noise: index exact; dB within 1e-3;
    fractional bin, bin value and |bin|^2 relative 1e-4."""
    n = 1 << sf
    rng = np.random.default_rng(sf)
    bins = rng.integers(0, n, (4, 3))
    i = np.arange(n)
    z = np.exp(2j * np.pi * (bins[..., None] + 0.2) * i / n)
    z = z + 0.05 * (rng.standard_normal(z.shape)
                    + 1j * rng.standard_normal(z.shape))
    zr, zi = z.real.astype(np.float32), z.imag.astype(np.float32)
    jd = jdetect.detect_ri(jnp.asarray(zr), jnp.asarray(zi))
    td = tdetect.detect_ri(torch.as_tensor(zr), torch.as_tensor(zi))
    assert td.index.dtype == torch.int32
    np.testing.assert_array_equal(_np(td.index), np.asarray(jd.index))
    np.testing.assert_array_equal(_np(td.index), bins)
    for f in ("power", "power_avg"):
        np.testing.assert_allclose(_np(getattr(td, f)),
                                   np.asarray(getattr(jd, f)), atol=1e-3)
    for f in ("findex", "bin_re", "bin_im", "mag2_max"):
        want = np.asarray(getattr(jd, f))
        np.testing.assert_allclose(_np(getattr(td, f)), want,
                                   atol=1e-4 * float(np.abs(want).max()),
                                   rtol=0)


# ---------------------------------------------------------------------------
# Window extraction and the CFO/timing estimator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("osr,decimate", [(1, True), (2, True), (2, False)])
def test_timing_shifted_windows_exact(osr, decimate):
    """A gather of the same samples: bit-equal, edge clamps included."""
    n = 128
    step = n * osr
    total = 5
    rng = np.random.default_rng(osr)
    r = rng.standard_normal((6, total * step)).astype(np.float32)
    i = rng.standard_normal((6, total * step)).astype(np.float32)
    t = np.array([0, step, -step, 3, -7, step - 1], np.int32)
    jr, ji = jmodem._timing_shifted_windows(
        jnp.asarray(r), jnp.asarray(i), jnp.asarray(t), total, step, osr, n,
        decimate=decimate)
    tr, ti = tmodem._timing_shifted_windows(
        torch.as_tensor(r), torch.as_tensor(i), torch.as_tensor(t), total,
        step, osr, n, decimate=decimate)
    np.testing.assert_array_equal(_np(tr), np.asarray(jr))
    np.testing.assert_array_equal(_np(ti), np.asarray(ji))
    # unbatched input
    ur, _ = tmodem._timing_shifted_windows(
        torch.as_tensor(r[1]), torch.as_tensor(i[1]), torch.as_tensor(t[1]),
        total, step, osr, n, decimate=decimate)
    np.testing.assert_array_equal(_np(ur), np.asarray(jr)[1])


def _impaired(sf, osr, seed, window="none"):
    """Packets with a sub-bin CFO, a timing shift and AWGN."""
    jp = J.LoraParams(sf=sf, osr=osr, window=window)
    rng = np.random.default_rng(seed)
    payloads = rng.integers(0, 256, (4, 8)).astype(np.uint8)
    re, im = J.modulate(J.encode(payloads), jp)
    z = np.asarray(re) + 1j * np.asarray(im)
    k = np.arange(z.shape[-1])
    cfo = rng.uniform(-0.3, 0.3, (4, 1)) / jp.n
    z = z * np.exp(2j * np.pi * cfo * k / osr)
    z = np.roll(z, 3, axis=-1)
    z = z + 0.05 * (rng.standard_normal(z.shape)
                    + 1j * rng.standard_normal(z.shape))
    return jp, z.real.astype(np.float32), z.imag.astype(np.float32)


@pytest.mark.parametrize("tie_break", [True, False])
@pytest.mark.parametrize("sf,osr,window", [(7, 1, "none"), (8, 2, "none"),
                                           (7, 1, "hann")])
def test_estimate_core_matches_jax(sf, osr, window, tie_break):
    """CFO within 1e-5, timing within 1e-3 samples."""
    jp, r, i = _impaired(sf, osr, sf + osr, window)
    tp = tconfig.params_from_reference(jp)
    je = jmodem._estimate_core(jnp.asarray(r), jnp.asarray(i), jp, 2,
                               tie_break_idx=tie_break)
    te = tmodem._estimate_core(torch.as_tensor(r), torch.as_tensor(i), tp, 2,
                               tie_break_idx=tie_break)
    np.testing.assert_allclose(_np(te.cfo), np.asarray(je.cfo), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(_np(te.time_offset),
                               np.asarray(je.time_offset), atol=1e-3, rtol=0)


def test_estimate_core_tie_break_on_equal_power():
    """Two oversampling phases of equal power: the tie-break variant takes
    the lower bin, the strict variant keeps the first phase — as in JAX."""
    p_t = T.LoraParams(sf=7, osr=2)
    p_j = J.LoraParams(sf=7, osr=2)
    n = p_t.n
    i = np.arange(n)
    r = np.zeros((1, 2 * p_t.step), np.float32)
    im = np.zeros_like(r)
    for s in range(2):
        # phase 0 carries bin 9, phase 1 bin 4, same amplitude
        seg = slice(s * p_t.step, (s + 1) * p_t.step)
        z = np.empty(p_t.step, np.complex128)
        z[0::2] = np.exp(2j * np.pi * 9 * i / n)
        z[1::2] = np.exp(2j * np.pi * 4 * i / n)
        r[0, seg], im[0, seg] = z.real, z.imag
    for tie in (True, False):
        je = jmodem._estimate_core(jnp.asarray(r), jnp.asarray(im), p_j, 2,
                                   tie_break_idx=tie)
        te = tmodem._estimate_core(torch.as_tensor(r), torch.as_tensor(im),
                                   p_t, 2, tie_break_idx=tie)
        np.testing.assert_allclose(_np(te.cfo), np.asarray(je.cfo), atol=1e-5)
        np.testing.assert_allclose(_np(te.time_offset),
                                   np.asarray(je.time_offset), atol=1e-3)


def test_estimate_offsets_matches_jax():
    jp, r, i = _impaired(7, 1, 4)
    tp = tconfig.params_from_reference(jp)
    je = J.estimate_offsets(jnp.asarray(r), jnp.asarray(i), jp)
    te = T.estimate_offsets(torch.as_tensor(r), torch.as_tensor(i), tp)
    np.testing.assert_allclose(_np(te.cfo), np.asarray(je.cfo), atol=1e-5)
    np.testing.assert_allclose(_np(te.time_offset),
                               np.asarray(je.time_offset), atol=1e-3)
    with pytest.raises(terrors.InvalidArgumentError):
        T.estimate_offsets(torch.zeros(1, 10), torch.zeros(1, 10), tp)


# ---------------------------------------------------------------------------
# compensate_offsets and the demodulate error contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("offs", [[0.2, 3.0, -5.0, 40.0],
                                  [-0.4, -64.0, 63.6, 7.0]])
def test_compensate_offsets_matches_jax(offs):
    """Shifts of 0, positive, negative and |off| >= count (left unshifted),
    batched and unbatched: zero fill exact, IQ within 2e-6."""
    jp = J.LoraParams(sf=5)
    tp = T.LoraParams(sf=5)
    count = 40
    rng = np.random.default_rng(abs(int(offs[1])))
    r = rng.standard_normal((4, count)).astype(np.float32)
    i = rng.standard_normal((4, count)).astype(np.float32)
    cfo = rng.uniform(-0.02, 0.02, 4).astype(np.float32)
    t_off = np.asarray(offs, np.float32)
    je = jmodem.OffsetEstimate(jnp.asarray(cfo), jnp.asarray(t_off))
    te = tmodem.OffsetEstimate(torch.as_tensor(cfo), torch.as_tensor(t_off))
    jr, ji = J.compensate_offsets(jnp.asarray(r), jnp.asarray(i), jp, je)
    gr, gi = T.compensate_offsets(torch.as_tensor(r), torch.as_tensor(i), tp,
                                  te)
    np.testing.assert_allclose(_np(gr), np.asarray(jr), atol=2e-6, rtol=0)
    np.testing.assert_allclose(_np(gi), np.asarray(ji), atol=2e-6, rtol=0)
    np.testing.assert_array_equal(_np(gr) == 0, np.asarray(jr) == 0)
    for b in range(4):
        ur, ui = T.compensate_offsets(
            torch.as_tensor(r[b]), torch.as_tensor(i[b]), tp,
            tmodem.OffsetEstimate(torch.as_tensor(cfo[b]),
                                  torch.as_tensor(t_off[b])))
        assert torch.equal(ur, gr[b]) and torch.equal(ui, gi[b])


def test_demodulate_error_contract():
    """A partial symbol -> InvalidArgumentError; fewer than two symbols or
    more data symbols than ``symbol_cap`` -> RangeError, as in JAX."""
    tp = T.LoraParams(sf=7)
    z = torch.zeros(1, 5 * tp.n)
    with pytest.raises(terrors.InvalidArgumentError):
        T.demodulate(z[:, :-1], z[:, :-1], tp)
    with pytest.raises(terrors.RangeError):
        T.demodulate(z[:, :tp.n], z[:, :tp.n], tp)
    with pytest.raises(terrors.RangeError, match="cap"):
        T.demodulate(z, z, tp, symbol_cap=2)
    res = T.demodulate(z, z, tp, symbol_cap=3)
    assert res.symbols.shape == (1, 3) and res.symbols.dtype == torch.int32
    assert res.power.shape == (1, 5)
    jp = J.LoraParams(sf=7)
    with pytest.raises(jerrors.RangeError, match="cap"):
        J.demodulate(jnp.zeros((1, 5 * jp.n)), jnp.zeros((1, 5 * jp.n)), jp,
                     symbol_cap=2)


@pytest.mark.parametrize("sf,nan_symbol", [(7, 4), (9, 0), (12, 3)])
def test_nan_window_gives_the_first_nan_bin_like_jax(sf, nan_symbol):
    """One NaN sample in one data symbol's window: every bin of that window
    is NaN, and the port's plain ``demodulate_tones`` and JAX's jnp route
    both give its first NaN bin, bin 0 (``ops/cuda_rx.py``'s non-finite
    rule); the other symbols, the sync word and the estimate are
    untouched, and the window's power is NaN in both."""
    jp, tp = J.LoraParams(sf=sf), T.LoraParams(sf=sf)
    pay = np.random.default_rng(sf).integers(0, 256, (2, 6)).astype(np.uint8)
    dr, di = (np.asarray(a) for a in J.modulate_dechirped(J.encode(pay), jp))
    dr, di = dr.copy(), di.copy()
    where = (2 + nan_symbol) * jp.n + jp.n // 3
    dr[1, where] = np.nan
    jres = J.demodulate_tones(jnp.asarray(dr), jnp.asarray(di), jp,
                              backend="jnp")
    tres = T.demodulate_tones(torch.as_tensor(dr), torch.as_tensor(di), tp)
    np.testing.assert_array_equal(tres.symbols.numpy(),
                                  np.asarray(jres.symbols))
    assert int(tres.symbols[1, nan_symbol]) == 0
    clean = np.asarray(J.encode(pay)).astype(np.int64) % jp.n
    keep = np.ones(clean.shape[-1], bool)
    keep[nan_symbol] = False
    np.testing.assert_array_equal(tres.symbols.numpy()[:, keep],
                                  clean[:, keep])
    np.testing.assert_array_equal(tres.sync_word.numpy(),
                                  np.asarray(jres.sync_word))
    np.testing.assert_allclose(tres.cfo.numpy(), np.asarray(jres.cfo),
                               atol=1e-5, rtol=0)
    assert np.isnan(tres.power.numpy()[1, 2 + nan_symbol])
    assert np.isnan(np.asarray(jres.power)[1, 2 + nan_symbol])


def test_full_float32_pins_and_restores_the_callers_switch():
    """``utils/tensors.py::full_float32`` runs its body at "highest"
    whatever the caller set, and gives the caller's precision back, also
    when the body raises; the DFT under it gives the same bins as with the
    switch off."""
    from lora_sdr_lightweight_standalone_library_clean_tpu_torch.ops.dft \
        import dft_ri
    from lora_sdr_lightweight_standalone_library_clean_tpu_torch.utils.tensors \
        import full_float32
    saved = torch.get_float32_matmul_precision()
    z = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (2, 3, 256)).astype(np.float32))
    try:
        torch.set_float32_matmul_precision("highest")
        want = dft_ri(z[0], z[1])
        for setting in ("high", "medium"):
            torch.set_float32_matmul_precision(setting)
            with full_float32():
                assert torch.get_float32_matmul_precision() == "highest"
            assert torch.get_float32_matmul_precision() == setting
            with pytest.raises(ZeroDivisionError):
                with full_float32():
                    1 / 0
            assert torch.get_float32_matmul_precision() == setting
            got = dft_ri(z[0], z[1])
            assert torch.get_float32_matmul_precision() == setting
            for a, b in zip(got, want):
                assert torch.equal(a, b)
    finally:
        torch.set_float32_matmul_precision(saved)
