"""The port's two-stage detect route against the JAX package, on the CPU.

``fused_rotate_detect_ref`` (the plain version of kernel #8) is held to the
JAX package's Pallas ``fused_rotate_detect`` in interpret mode, and
``demodulate_tones``/``demodulate`` with ``backend="pallas"`` to the JAX
entry points with the same backend, interpret mode patched in as
tests/test_pallas.py:176-182 does (nothing in the JAX package changes).
Inputs are made with numpy from fixed seeds and handed to both packages.

Tolerances: bins, symbols and sync words exact (the inputs hold clear
tones); dB within 0.05 (the matmul DFTs sum in other orders,
tests/test_pallas.py:64-67); CFO within 1e-5, timing within 1e-3 samples.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")

import torch  # noqa: E402

import lora_sdr_lightweight_standalone_library_clean_tpu as J  # noqa: E402
from lora_sdr_lightweight_standalone_library_clean_tpu.ops import (  # noqa: E402
    pallas_detect)

import lora_sdr_lightweight_standalone_library_clean_tpu_torch as T  # noqa: E402
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.ops import (  # noqa: E402
    cuda_detect)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.utils import (  # noqa: E402
    errors as terrors)

torch.set_num_threads(1)

DB_ATOL = 0.05


def _tone_windows(n, shape, seed):
    """Tones at random bins with |cfo| up to half a bin, AWGN sigma 0.1,
    a rotation rate ~ N(0, 1e-3) and start phases ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    b, s = shape
    k = rng.integers(0, n, (b, s, 1)) + rng.uniform(-0.5, 0.5, (b, s, 1))
    z = np.exp(2j * np.pi * k * np.arange(n) / n)
    z = z + (rng.standard_normal(z.shape)
             + 1j * rng.standard_normal(z.shape)) * 0.1
    rate = (rng.standard_normal(b) * 1e-3).astype(np.float32)
    start = rng.standard_normal((b, s)).astype(np.float32)
    return (z.real.astype(np.float32), z.imag.astype(np.float32), rate,
            start)


@pytest.mark.parametrize("shape", [(3, 6), (1, 4)], ids=["batched", "one"])
@pytest.mark.parametrize("sf", [5, 7, 9])
def test_rotate_detect_matches_jax_kernel(sf, shape):
    n = 1 << sf
    zr, zi, rate, start = _tone_windows(n, shape, seed=sf)
    gi, gp, ga = cuda_detect.fused_rotate_detect(
        *(torch.as_tensor(a) for a in (zr, zi, rate, start)))
    wi, wp, wa = pallas_detect.fused_rotate_detect(
        *(jnp.asarray(a) for a in (zr, zi, rate, start)), interpret=True)
    assert gi.shape == shape and gi.dtype == torch.int32
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), atol=DB_ATOL,
                               rtol=0)
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), atol=DB_ATOL,
                               rtol=0)


def test_rotate_detect_clean_tones():
    """Pure tones at known bins, no rotation: exact bins at 0 dB."""
    n = 128
    bins = np.array([[0, 3, 64, 127, 5, 99]])
    z = np.exp(2j * np.pi * bins[..., None] * np.arange(n) / n)
    idx, power, _ = cuda_detect.fused_rotate_detect(
        torch.as_tensor(z.real.astype(np.float32)),
        torch.as_tensor(z.imag.astype(np.float32)), torch.zeros(1),
        torch.zeros(1, 6))
    assert idx.tolist() == bins.tolist()
    assert float(power.abs().max()) < 0.01


def _interpret(monkeypatch):
    orig = pallas_detect.fused_rotate_detect
    monkeypatch.setattr(pallas_detect, "fused_rotate_detect",
                        lambda *a, **k: orig(*a, interpret=True, **k))


def _noisy_packets(jp, packets, seed, raw=False):
    rng = np.random.default_rng(seed)
    pay = rng.integers(0, 256, (packets, 12)).astype(np.uint8)
    re, im = J.modulate(J.encode(pay), jp)
    if not raw:
        re, im = J.dechirp(re, im, jp)
    re = np.asarray(re) + rng.standard_normal(re.shape) * 0.05
    im = np.asarray(im) + rng.standard_normal(im.shape) * 0.05
    return re.astype(np.float32), im.astype(np.float32), pay


def _assert_demod_equal(tres, jres):
    np.testing.assert_array_equal(tres.symbols.numpy(),
                                  np.asarray(jres.symbols))
    np.testing.assert_array_equal(tres.sync_word.numpy(),
                                  np.asarray(jres.sync_word))
    np.testing.assert_allclose(tres.cfo.numpy(), np.asarray(jres.cfo),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(tres.time_offset.numpy(),
                               np.asarray(jres.time_offset), atol=1e-3,
                               rtol=0)
    for f in ("power", "power_avg"):
        np.testing.assert_allclose(getattr(tres, f).numpy(),
                                   np.asarray(getattr(jres, f)),
                                   atol=DB_ATOL, rtol=0)


@pytest.mark.parametrize("sf,osr,window", [
    (7, 1, "none"), (7, 1, "hann"), (7, 2, "none"), (9, 1, "hann")])
def test_demodulate_tones_backend_pallas_matches_jax(monkeypatch, sf, osr,
                                                     window):
    jp = J.LoraParams(sf=sf, osr=osr, window=window)
    tp = T.params_from_reference(jp)
    dr, di, pay = _noisy_packets(jp, 4, seed=sf + osr)
    dr, di = dr * 3.0, di * 3.0           # the peak normalisation acts
    _interpret(monkeypatch)
    jres = J.demodulate_tones(jnp.asarray(dr), jnp.asarray(di), jp,
                              backend="pallas")
    tres = T.demodulate_tones(torch.as_tensor(dr), torch.as_tensor(di), tp,
                              backend="pallas")
    _assert_demod_equal(tres, jres)
    auto = T.demodulate_tones(torch.as_tensor(dr), torch.as_tensor(di), tp)
    assert torch.equal(auto.symbols, tres.symbols)
    if osr == 1:
        dec, _ = T.decode(tres.symbols)
        np.testing.assert_array_equal(dec.numpy(), pay)


@pytest.mark.parametrize("sf,window", [(7, "none"), (8, "hann")])
def test_demodulate_backend_pallas_matches_jax(monkeypatch, sf, window):
    jp = J.LoraParams(sf=sf, window=window)
    tp = T.params_from_reference(jp)
    re, im, _ = _noisy_packets(jp, 4, seed=20 + sf, raw=True)
    _interpret(monkeypatch)
    jres = J.demodulate(jnp.asarray(re), jnp.asarray(im), jp,
                        backend="pallas")
    tres = T.demodulate(torch.as_tensor(re), torch.as_tensor(im), tp,
                        backend="pallas")
    _assert_demod_equal(tres, jres)
    auto = T.demodulate(torch.as_tensor(re), torch.as_tensor(im), tp,
                        backend="pallas_rx")
    assert torch.equal(auto.symbols, tres.symbols)


def test_backend_pallas_on_leading_axes_and_above_512_points():
    """Two leading axes flatten into the kernel's batch; on a CPU tensor
    the plain version also takes sf10 (the card raises there)."""
    for sf in (7, 10):
        p = T.LoraParams(sf=sf)
        jp = J.LoraParams(sf=sf)
        dr, di, _ = _noisy_packets(jp, 4, seed=sf)
        r3 = torch.as_tensor(dr).reshape(2, 2, -1)
        i3 = torch.as_tensor(di).reshape(2, 2, -1)
        got = T.demodulate_tones(r3, i3, p, backend="pallas")
        flat = T.demodulate_tones(torch.as_tensor(dr), torch.as_tensor(di),
                                  p, backend="pallas")
        assert torch.equal(got.symbols.reshape(4, -1), flat.symbols)
        assert torch.equal(got.sync_word.reshape(4), flat.sync_word)
        auto = T.demodulate_tones(torch.as_tensor(dr), torch.as_tensor(di),
                                  p)
        assert torch.equal(auto.symbols, flat.symbols)


@pytest.mark.parametrize("backend", ["jnp", "mxu", ""])
def test_backend_values_that_raise(backend):
    p = T.LoraParams(sf=7)
    z = torch.zeros(1, 4 * p.step)
    with pytest.raises(terrors.InvalidArgumentError, match="CPU tensor"):
        T.demodulate_tones(z, z, p, backend=backend)
    with pytest.raises(terrors.InvalidArgumentError, match="CPU tensor"):
        T.demodulate(z, z, p, backend=backend)
