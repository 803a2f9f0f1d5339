"""The port's channel (``ops/channel.py``) and sweep (``models/sweep.py``)
against the JAX package's, on the CPU.

torch cannot reproduce ``jax.random``'s draws, so the comparisons feed both
packages the same noise: the JAX package's own unit draws go through the
port's ``_add_noise`` (IQ within 1e-6), and the JAX package's own noisy
planes through the port's ``_sweep_metrics``, which must give the JAX
sweep step's SER/BER/PER/CRC rate within one symbol or one packet of the
batch.  ``ser_theory`` and the SNR helpers are numpy in both: within 1e-12.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")

import torch  # noqa: E402

import lora_sdr_lightweight_standalone_library_clean_tpu as J  # noqa: E402
from lora_sdr_lightweight_standalone_library_clean_tpu.models import (  # noqa: E402
    sweep as jsweep)
from lora_sdr_lightweight_standalone_library_clean_tpu.ops import (  # noqa: E402
    channel as jch)

import lora_sdr_lightweight_standalone_library_clean_tpu_torch as T  # noqa: E402
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.models import (  # noqa: E402
    sweep as tsweep)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.ops import (  # noqa: E402
    channel as tch)

torch.set_num_threads(1)

IQ_ATOL = 1e-6


def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("snr_db", [10.0, -7.5, [3.0, -12.0, 0.5]])
def test_awgn_on_jax_draws_matches_jax(snr_db):
    """The port's noise arithmetic on JAX's own unit draws gives JAX's
    ``awgn`` output (scalar and per-packet SNR)."""
    r, i = _planes((3, 512), 1)
    key = jax.random.PRNGKey(4)
    jr, ji = jch.awgn(key, jnp.asarray(r), jnp.asarray(i), snr_db)
    kr, ki = jax.random.split(key)
    nr = np.asarray(jax.random.normal(kr, r.shape, jnp.float32))
    ni = np.asarray(jax.random.normal(ki, i.shape, jnp.float32))
    tr, ti = tch._add_noise(torch.as_tensor(r), torch.as_tensor(i), snr_db,
                            torch.as_tensor(nr), torch.as_tensor(ni))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=IQ_ATOL,
                               rtol=0)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=IQ_ATOL,
                               rtol=0)


def test_awgn_snr_calibration_and_generator():
    """Noise power at 10 dB within 0.3 dB (tests/test_sweep.py's check),
    drawn on the planes' device from the caller's generator: the same seed
    gives the same noise, another seed other noise."""
    sig = torch.ones(1, 1 << 14)
    zero = torch.zeros_like(sig)
    gen = torch.Generator().manual_seed(0)
    zr, zi = tch.awgn(gen, sig, zero, 10.0)
    power = float(((zr - sig) ** 2 + zi ** 2).mean())
    assert abs(10 * np.log10(1.0 / power) - 10.0) < 0.3
    again = tch.awgn(torch.Generator().manual_seed(0), sig, zero, 10.0)
    other = tch.awgn(torch.Generator().manual_seed(1), sig, zero, 10.0)
    assert torch.equal(again[0], zr) and torch.equal(again[1], zi)
    assert not torch.equal(other[0], zr)


@pytest.mark.parametrize("per_symbol", [True, False])
def test_inject_cfo_matches_jax(per_symbol):
    r, i = _planes((2, 4 * 128), 2)
    cfo = np.array([0.37, -1.25], np.float32)
    jr, ji = jch.inject_cfo(jnp.asarray(r), jnp.asarray(i), cfo, 128,
                            per_symbol)
    tr, ti = tch.inject_cfo(torch.as_tensor(r), torch.as_tensor(i),
                            torch.as_tensor(cfo), 128, per_symbol)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=IQ_ATOL,
                               rtol=0)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=IQ_ATOL,
                               rtol=0)


@pytest.mark.parametrize("shift", [0, 3, -2, 40, -40])
def test_inject_time_offset_matches_jax(shift):
    r, i = _planes((2, 32), 3)
    jr, ji = jch.inject_time_offset(jnp.asarray(r), jnp.asarray(i), shift)
    tr, ti = tch.inject_time_offset(torch.as_tensor(r), torch.as_tensor(i),
                                    shift)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_apply_channel_composes_like_jax():
    """CFO then shift (no noise) equal to JAX's; with an SNR the port adds
    its generator's draws after them, as ``awgn`` alone would."""
    r, i = _planes((2, 256), 5)
    jr, ji = jch.apply_channel(None, jnp.asarray(r), jnp.asarray(i),
                               cfo_bins=0.4, time_offset=7, n_step=128)
    tr, ti = tch.apply_channel(None, torch.as_tensor(r), torch.as_tensor(i),
                               cfo_bins=0.4, time_offset=7, n_step=128)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=IQ_ATOL,
                               rtol=0)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=IQ_ATOL,
                               rtol=0)
    nr, ni = tch.apply_channel(torch.Generator().manual_seed(9), tr, ti,
                               snr_db=5.0)
    wr, wi = tch.awgn(torch.Generator().manual_seed(9), tr, ti, 5.0)
    assert torch.equal(nr, wr) and torch.equal(ni, wi)


@pytest.mark.parametrize("receiver,kw,snrs", [
    ("tones", dict(sf=7), (-9.5, -8.5, -7.0)),
    ("wide", dict(sf=9, bw=250000, cr="4/8", osr=2), (-17.0, -16.0, -14.5)),
])
def test_sweep_metrics_on_jax_planes_match_jax(receiver, kw, snrs):
    """64 packets, 3 SNRs: the JAX sweep step's key sequence and noisy
    planes; the port's metrics on those planes within one symbol (SER),
    one byte's bits (BER) and one packet (PER, CRC rate) of JAX's."""
    packets, nbytes, seed = 64, 16, 3
    jp, tp = J.LoraParams(**kw), T.LoraParams(**kw)
    rng = np.random.default_rng(seed)
    payloads = rng.integers(0, 256, (packets, nbytes)).astype(np.uint8)
    step = jsweep._sweep_step(jp, receiver)
    jsyms = J.encode(payloads)
    jdr, jdi = J.dechirp(*J.modulate(jsyms, jp), jp)
    tpay = torch.as_tensor(payloads)
    tsyms, tdr, tdi = tsweep._sweep_chain(tpay, tp)
    np.testing.assert_array_equal(tsyms.numpy(), np.asarray(jsyms))
    np.testing.assert_allclose(tdr.numpy(), np.asarray(jdr), atol=4e-6,
                               rtol=0)
    nsym = tsyms.numel()
    key = jax.random.PRNGKey(seed)
    for snr in snrs:
        key, sub = jax.random.split(key)
        want = [float(x) for x in step(sub, jnp.asarray(payloads),
                                       jnp.float32(snr))]
        nr, ni = jch.awgn(sub, jdr, jdi, jnp.float32(snr))
        got = [float(x) for x in tsweep._sweep_metrics(
            tpay, tsyms, torch.as_tensor(np.asarray(nr)),
            torch.as_tensor(np.asarray(ni)), tp, receiver)]
        tol = (1.0 / nsym, 8.0 / (packets * nbytes * 8), 1.0 / packets,
               1.0 / packets)
        for name, g, w, t in zip(("ser", "ber", "per", "crc"), got, want,
                                 tol):
            assert abs(g - w) <= t + 1e-7, (snr, name, g, w)
        assert 0.0 < want[2] < 1.0 or snr == snrs[-1], (snr, want)


def test_ser_theory_and_snr_helpers_match_jax():
    for sf in (7, 9, 12):
        snrs = np.array([-30.0, -20.0, -12.5, -9.0, -5.0])
        np.testing.assert_allclose(tsweep.ser_theory(snrs, sf),
                                   jsweep.ser_theory(snrs, sf), atol=1e-12,
                                   rtol=0)
        assert abs(tsweep.ser_theory(-10.0, sf)
                   - jsweep.ser_theory(-10.0, sf)) <= 1e-12
    assert abs(tsweep.snr_at_ser_theory(1e-2, 7)
               - jsweep.snr_at_ser_theory(1e-2, 7)) <= 1e-12
    pts = [tsweep.SweepPoint(s, e, 0.0, p, 0.0) for s, e, p in
           ((-10.0, 0.5, 0.9), (-8.0, 0.05, 0.2), (-6.0, 1e-3, 5e-3))]
    jpts = [jsweep.SweepPoint(*p) for p in pts]
    for field in ("ser", "per"):
        assert abs(tsweep.snr_at_level(pts, 1e-2, field)
                   - jsweep.snr_at_level(jpts, 1e-2, field)) <= 1e-12
    with pytest.raises(ValueError):
        tsweep.snr_at_level(pts, 1e-6)


def test_per_sweep_on_cpu_monotone():
    """PER ~1 at -30 dB and ~0 at 0 dB for sf7, on the CPU (the JAX
    package's tests/test_sweep.py::test_per_sweep_monotone)."""
    pts = T.sweep.per_sweep(T.LoraParams(sf=7), [-30.0, 0.0], packets=64,
                            payload_len=8, seed=1, device="cpu")
    assert pts[0].per > 0.9 and pts[1].per < 0.05 and pts[1].ser < 0.05
    assert isinstance(pts[0], T.sweep.SweepPoint)
    assert pts[0].snr_db == -30.0
