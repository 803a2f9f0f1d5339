"""The port's oversampled and wide receivers against the JAX package.

The plain versions of the osr > 1 TX kernel (``_tx_osr_kernel``), the
decimated and halo RX windows (``_rx_kernel``'s padded/slab and halo forms)
and the 8192/16384-point wide detection are held to the JAX package's
Pallas kernels in interpret mode, as tests/test_pallas.py runs them;
``demodulate_wide`` and the wide pipeline to the JAX package's jnp path.
Inputs are made with numpy from fixed seeds and handed to both packages.
Tolerances: TX IQ within 2e-6 (4e-6 with the folded down-chirp,
tests/test_pallas.py:386-397); RX bins exact and dB within 1e-3; symbols,
sync words, bytes and CRC verdicts exact; CFO within 1e-5; timing within
1e-3 samples.  These are heavy cases, kept in one file so that one worker
of a parallel run takes them alone.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")

import torch  # noqa: E402

import lora_sdr_lightweight_standalone_library_clean_tpu as J  # noqa: E402
from lora_sdr_lightweight_standalone_library_clean_tpu.ops import (  # noqa: E402
    channel, pallas_rx, pallas_tx)
from lora_sdr_lightweight_standalone_library_clean_tpu.ops.chirp import (  # noqa: E402
    _with_sync_prelude as j_prelude)

import lora_sdr_lightweight_standalone_library_clean_tpu_torch as T  # noqa: E402
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.models import (  # noqa: E402
    modem as tmodem)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.ops import (  # noqa: E402
    cuda_rx, cuda_tx)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.ops.chirp import (  # noqa: E402
    _with_sync_prelude)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.utils import (  # noqa: E402
    errors as terrors)

torch.set_num_threads(1)

DB_ATOL = 1e-3
WIDE_PROFILES = [(9, 250000, 2), (12, 500000, 4)]


def _cpu(*arrays):
    return [torch.as_tensor(np.asarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# #3: the osr > 1 TX kernel's plain version against _tx_osr_kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dechirp,atol", [(False, 2e-6), (True, 4e-6)])
@pytest.mark.parametrize("sf,bw,osr", [
    (9, 250000, 2),     # q = 512 dense, ungated
    (12, 500000, 4),    # q = 4096 factored, ungated
    (7, 125000, 2),     # q = 256 dense, gated
    (8, 125000, 4),     # q = 1024 factored, gated
])
def test_tx_osr_ref_matches_pallas_tx_osr(sf, bw, osr, dechirp, atol):
    """Symbols over [0, 2n), the closed form's range, so both wrap gates
    fire: IQ within 2e-6 (4e-6 with the folded down-chirp)."""
    n = 1 << sf
    syms = np.random.default_rng(100 + sf).integers(0, 2 * n, (3, 5))
    syms = syms.astype(np.int32)
    jp = J.LoraParams(sf=sf, bw=bw, osr=osr)
    wr, wi = pallas_tx.tx_tone_synth(j_prelude(jnp.asarray(syms), jp), jp,
                                     amplitude=0.75, dechirp=dechirp,
                                     interpret=True)
    tp = T.LoraParams(sf=sf, bw=bw, osr=osr)
    gr, gi = cuda_tx.tx_tone_synth_ref(
        _with_sync_prelude(torch.as_tensor(syms), tp), tp, amplitude=0.75,
        dechirp=dechirp)
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), atol=atol, rtol=0)
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), atol=atol, rtol=0)


@pytest.mark.parametrize("sf,bw,osr", [(7, 125000, 2), (12, 500000, 4)])
def test_tx_osr_mult_rows_bit_equal(sf, bw, osr):
    """The multiplier kept by carry class is bit-equal to the JAX package's
    S*bs rows, and so is the wrap tone."""
    bs = J.LoraParams(sf=sf, bw=bw).bw_scale
    s_total = 9
    for dechirp in (False, True):
        jm = pallas_tx._tx_osr_mult(sf, bs, osr, s_total, 0.75, dechirp)
        tm = cuda_tx._tx_osr_mult(sf, bs, osr, 0.75, dechirp)
        period = cuda_tx._carry_period(sf, bs, osr)
        cls = ((np.arange(s_total) % period)[:, None] * bs
               + np.arange(bs)).reshape(-1)
        assert jm[0].tobytes() == tm[0][cls].tobytes()
        assert jm[1].tobytes() == tm[1][cls].tobytes()
        assert jm[2].reshape(-1).tobytes() == tm[2].tobytes()
        assert jm[3].reshape(-1).tobytes() == tm[3].tobytes()
        assert jm[4] == bool(bs % osr)


@pytest.mark.parametrize("sf,bw,osr", [(7, 125000, 2), (9, 250000, 2),
                                       (12, 500000, 4), (12, 125000, 2)])
def test_modulate_at_osr_matches_jax(sf, bw, osr):
    """``modulate`` (closed form on the CPU, both packages) within 2e-6;
    ``modulate_dechirped`` within 4e-6: the TX kernel's plain version where
    it applies (q <= 4096), modulate then dechirp at sf12/BW125/osr2
    (q = 8192), against JAX's modulate then dechirp."""
    syms = np.random.default_rng(sf + osr).integers(0, 1 << sf, (2, 4))
    jp = J.LoraParams(sf=sf, bw=bw, osr=osr)
    tp = T.params_from_reference(jp)
    tsyms = torch.as_tensor(syms)
    jr, ji = J.modulate(syms.astype(np.uint16), jp)
    mr, mi = T.modulate(tsyms, tp)
    np.testing.assert_allclose(mr.numpy(), np.asarray(jr), atol=2e-6, rtol=0)
    np.testing.assert_allclose(mi.numpy(), np.asarray(ji), atol=2e-6, rtol=0)
    wr, wi = J.modulate_dechirped(syms.astype(np.uint16), jp)
    gr, gi = T.modulate_dechirped(tsyms, tp)
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), atol=4e-6, rtol=0)
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), atol=4e-6, rtol=0)


# ---------------------------------------------------------------------------
# #6 and #5: decimated, halo and wide windows against _rx_kernel
# ---------------------------------------------------------------------------

def _rx_inputs(sf, bw, osr, seed, t_first, packets=2, nbytes=2):
    """Pre-dechirped packets with AWGN (sigma 0.03), t_off starting with
    ``t_first``, rate ~ N(0, 1e-4), scale in [0.5, 1]
    (tests/test_pallas.py:198-211)."""
    p = J.LoraParams(sf=sf, bw=bw, osr=osr)
    rng = np.random.default_rng(seed)
    pay = rng.integers(0, 256, (packets, nbytes)).astype(np.uint8)
    dr, di = J.dechirp(*J.modulate(J.encode(pay), p), p)
    dr = np.asarray(dr) + rng.standard_normal(dr.shape).astype(np.float32) * 0.03
    di = np.asarray(di) + rng.standard_normal(di.shape).astype(np.float32) * 0.03
    t_off = rng.integers(-p.step, p.step + 1, packets).astype(np.int32)
    t_off[:len(t_first)] = t_first
    rate = (rng.standard_normal(packets) * 1e-4).astype(np.float32)
    scale = rng.uniform(0.5, 1.0, packets).astype(np.float32)
    return p, [dr, di, t_off, rate, scale]


def _mults(sf, bw_scale, ndft, osr_rep=1):
    """ones, Hann, down-chirp x Hann (the full-RX multiplier)."""
    n = 1 << sf
    hann = np.repeat(J.models.modem.window_table(n, J.Window.HANN), osr_rep)
    dr, di = tmodem._full_rx_mult(sf, bw_scale, T.Window.HANN)
    return {"ones": (np.ones(ndft, np.float32), np.zeros(ndft, np.float32)),
            "hann": (hann, np.zeros(ndft, np.float32)),
            "downchirp_hann": (dr, di)}


def _rx_compare(jp, arrays, mr, mi, wide=False, halo=(0, 0)):
    want = pallas_rx.rx_window_detect(
        *(jnp.asarray(a) for a in arrays + [mr, mi]), jp, wide=wide,
        halo=halo, interpret=True)
    got = cuda_rx.rx_window_detect_ref(
        *_cpu(*arrays, mr, mi), T.params_from_reference(jp), wide=wide,
        halo=halo)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=DB_ATOL,
                                   rtol=0)
    return got


@pytest.mark.parametrize("sf,osr", [(7, 2), (7, 4), (9, 2), (10, 4)])
def test_rx_decimated_ref_matches_pallas_rx(sf, osr):
    """Decimated osr > 1 windows, t_off 0, +-step and osr + 1 (a nonzero
    decimation phase), with ones, Hann and down-chirp x Hann: bins exact,
    dB within 1e-3."""
    p0 = J.LoraParams(sf=sf, osr=osr)
    jp, arrays = _rx_inputs(sf, 125000, osr, sf * 10 + osr,
                            [0, p0.step, -p0.step, osr + 1], packets=4)
    for mr, mi in _mults(sf, 1, jp.n).values():
        _rx_compare(jp, arrays, mr, mi)


@pytest.mark.parametrize("halo", [(1, 1), (1, 0), (0, 1)])
def test_rx_halo_wide_ref_matches_pallas_rx(halo):
    """Halo calls of the wide detection at sf9/BW250/osr2 (1,024 points):
    only stream rows h0 ... S-h1-1 are detected, the edge clamp keys on the
    stream row and the rotation on the detected row; bins exact, dB within
    1e-3."""
    p0 = J.LoraParams(sf=9, bw=250000, osr=2)
    jp, arrays = _rx_inputs(9, 250000, 2, 91, [p0.step, -p0.step])
    mr, mi = _mults(9, 2, jp.step, osr_rep=2)["hann"]
    got = _rx_compare(jp, arrays, mr, mi, wide=True, halo=halo)
    assert got[0].shape[-1] == arrays[0].shape[-1] // jp.step - sum(halo)


@pytest.mark.parametrize("sf,bw,osr", [(11, 500000, 4), (12, 500000, 4)])
def test_rx_wide_8192_16384_ref_matches_pallas_rx(sf, bw, osr):
    """The wide detection at 8192 and 16384 points: bins exact, dB within
    1e-3."""
    p0 = J.LoraParams(sf=sf, bw=bw, osr=osr)
    jp, arrays = _rx_inputs(sf, bw, osr, sf, [0, -p0.step])
    mr, mi = _mults(sf, 4, jp.step, osr_rep=osr)["ones"]
    _rx_compare(jp, arrays, mr, mi, wide=True)


def test_rx_halo_on_decimated_windows_raises():
    """The JAX package asserts halo == (0, 0) or osr == 1 in the window."""
    p = T.LoraParams(sf=7, osr=2)
    z = torch.zeros(1, 4 * p.step)
    one = torch.ones(1)
    with pytest.raises(terrors.InvalidArgumentError, match="halo"):
        cuda_rx.rx_window_detect(z, z, torch.zeros(1, dtype=torch.int32),
                                 one, one, torch.ones(p.n), torch.zeros(p.n),
                                 p, halo=(1, 0))


# ---------------------------------------------------------------------------
# demodulate_wide and the wide pipeline against the JAX package
# ---------------------------------------------------------------------------

def _wide_inputs(sf, bw, osr, impaired):
    """Random symbols, modulated and dechirped by the JAX package, then
    either AWGN sigma 0.01 (tests/test_pallas.py:246-253) or the
    impairments of tests/test_wide.py:57 (CFO 0.2 bins, a 2-sample shift,
    25 dB SNR), the noise from numpy."""
    jp = J.LoraParams(sf=sf, bw=bw, osr=osr)
    rng = np.random.default_rng(sf + 10 * impaired)
    # the pipeline test's shape, so the JAX package's eager ops compile once
    syms = rng.integers(0, jp.n, (8, 12)).astype(np.uint16)
    re, im = J.modulate(syms, jp)
    sigma = 0.01
    if impaired:
        re, im = channel.inject_cfo(re, im, 0.2, jp.step)
        re, im = channel.inject_time_offset(re, im, 2)
        sigma = float(np.sqrt(0.5) * 10.0 ** (-25.0 / 20.0))
    dr, di = J.dechirp(re, im, jp)
    dr = np.asarray(dr) + rng.standard_normal(dr.shape).astype(np.float32) * sigma
    di = np.asarray(di) + rng.standard_normal(di.shape).astype(np.float32) * sigma
    return jp, syms, dr.astype(np.float32), di.astype(np.float32)


@pytest.mark.parametrize("impaired", [False, True])
@pytest.mark.parametrize("sf,bw,osr", WIDE_PROFILES)
def test_demodulate_wide_matches_jax(sf, bw, osr, impaired):
    """Symbols and sync word exact (and equal to what was sent); CFO within
    1e-5; timing within 1e-3 samples and rounded exact; dB within 1e-3."""
    jp, syms, dr, di = _wide_inputs(sf, bw, osr, impaired)
    want = J.demodulate_wide(jnp.asarray(dr), jnp.asarray(di), jp,
                             backend="jnp")
    got = T.demodulate_wide(*_cpu(dr, di), T.params_from_reference(jp))
    np.testing.assert_array_equal(got.symbols.numpy(),
                                  np.asarray(want.symbols))
    np.testing.assert_array_equal(got.symbols.numpy(), syms)
    np.testing.assert_array_equal(got.sync_word.numpy(),
                                  np.asarray(want.sync_word))
    np.testing.assert_allclose(got.cfo.numpy(), np.asarray(want.cfo),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.time_offset.numpy(),
                               np.asarray(want.time_offset), atol=1e-3,
                               rtol=0)
    np.testing.assert_array_equal(np.round(got.time_offset.numpy()),
                                  np.round(np.asarray(want.time_offset)))
    for f in ("power", "power_avg"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   atol=DB_ATOL, rtol=0)


def test_demodulate_wide_requires_enough_osr():
    """osr < bw_scale is refused, as in tests/test_wide.py:74."""
    p = T.LoraParams(sf=9, bw=250000, osr=1)
    z = torch.zeros(4 * p.step)
    with pytest.raises(terrors.InvalidArgumentError):
        T.demodulate_wide(z, z, p)
    with pytest.raises(J.errors.InvalidArgumentError):
        J.demodulate_wide(jnp.zeros(4 * p.step), jnp.zeros(4 * p.step),
                          J.LoraParams(sf=9, bw=250000, osr=1))


@pytest.mark.parametrize("sf,bw,osr", WIDE_PROFILES)
def test_wide_pipeline_matches_jax(sf, bw, osr):
    """``encode -> modulate_dechirped -> demodulate_wide -> decode`` on 8
    CRC-valid and altered packets: bytes and CRC verdicts equal JAX's and
    what was sent, sync word exact."""
    rng = np.random.default_rng(200 + sf)
    pay = rng.integers(0, 256, (8, 6)).astype(np.uint8)
    crc = np.asarray(J.crc_sx1272(pay[:, 2:4])).astype(np.int64)
    pay[:, 4] = crc & 0xFF
    pay[:, 5] = crc >> 8
    pay[::3, 2] ^= 0x5A
    jp = J.LoraParams(sf=sf, bw=bw, osr=osr)
    tp = T.params_from_reference(jp)
    jres = J.demodulate_wide(*J.modulate_dechirped(J.encode(pay), jp), jp)
    jdec, jok = J.decode(jres.symbols)
    tres = T.demodulate_wide(
        *T.modulate_dechirped(T.encode(torch.as_tensor(pay)), tp), tp)
    tdec, tok = T.decode(tres.symbols)
    np.testing.assert_array_equal(tdec.numpy(), np.asarray(jdec))
    np.testing.assert_array_equal(tdec.numpy(), pay)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert tok.numpy().tolist() == [i % 3 != 0 for i in range(len(pay))]
    np.testing.assert_array_equal(tres.sync_word.numpy(),
                                  np.asarray(jres.sync_word))
    assert (tres.sync_word.numpy() == 0x12).all()


def test_decimated_osr2_pipeline_matches_jax():
    """``encode -> modulate_dechirped -> demodulate_tones -> decode`` at
    sf7/BW125/osr2 on 8 packets: symbols, bytes and CRC verdicts equal
    JAX's.  Neither package decodes every packet here: the estimate puts
    the timing at 1 sample, and the last row (the edge clamp for t > 0)
    reads its unshifted samples at phase 0, so the last symbol is exact or
    one bin low; every other symbol is exact."""
    rng = np.random.default_rng(207)
    pay = rng.integers(0, 256, (8, 6)).astype(np.uint8)
    crc = np.asarray(J.crc_sx1272(pay[:, 2:4])).astype(np.int64)
    pay[:, 4] = crc & 0xFF
    pay[:, 5] = crc >> 8
    jp = J.LoraParams(sf=7, bw=125000, osr=2)
    tp = T.params_from_reference(jp)
    jres = J.demodulate_tones(*J.modulate_dechirped(J.encode(pay), jp), jp)
    jdec, jok = J.decode(jres.symbols)
    syms = T.encode(torch.as_tensor(pay))
    tres = T.demodulate_tones(*T.modulate_dechirped(syms, tp), tp)
    tdec, tok = T.decode(tres.symbols)
    np.testing.assert_array_equal(tres.symbols.numpy(),
                                  np.asarray(jres.symbols))
    np.testing.assert_array_equal(tdec.numpy(), np.asarray(jdec))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert (tres.time_offset.numpy() == 1).all()
    want = (syms % tp.n).numpy()
    got = tres.symbols.numpy()
    np.testing.assert_array_equal(got[:, :-1], want[:, :-1])
    assert set(((want[:, -1] - got[:, -1]) % tp.n).tolist()) <= {0, 1}
    exact = (tdec.numpy() == pay).all(axis=1)
    assert (tok.numpy() == exact).all()
