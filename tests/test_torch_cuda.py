"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode).  The file imports neither jax nor the JAX
package, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest`` skips tests/conftest.py, which configures jax).
Tolerances: TX IQ within 4e-6 (the kernel and its plain version read the
same table rows); RX bins exact and dB within 0.05 (the kernel's FFT and the
plain version's dense-matmul DFT sum in different orders).
"""
import numpy as np
import pytest
import torch

import lora_sdr_lightweight_standalone_library_clean_tpu_torch as T
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.ops import (
    cuda_rx, cuda_tx)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.ops.chirp import (
    _with_sync_prelude)

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _rx_inputs(p, seed, packets=16, nbytes=16):
    """Real pre-dechirped packets with AWGN (sigma 0.03), t_off including
    0 and +-step, rate ~ N(0, 1e-4), scale in [0.5, 1]."""
    rng = np.random.default_rng(seed)
    pay = rng.integers(0, 256, (packets, nbytes)).astype(np.uint8)
    dr, di = T.modulate_dechirped(T.encode(pay), p)          # CPU: plain
    dr = dr.numpy() + rng.standard_normal(dr.shape).astype(np.float32) * 0.03
    di = di.numpy() + rng.standard_normal(di.shape).astype(np.float32) * 0.03
    t_off = rng.integers(-p.step, p.step + 1, packets).astype(np.int32)
    t_off[:3] = [0, p.step, -p.step]
    rate = (rng.standard_normal(packets) * 1e-4).astype(np.float32)
    scale = rng.uniform(0.5, 1.0, packets).astype(np.float32)
    return dr, di, t_off, rate, scale


@pytest.mark.parametrize("sf", [2, 5, 7, 8, 9])
def test_tx_kernel_matches_plain_on_card(cuda_device, sf):
    p = T.LoraParams(sf=sf)
    rng = np.random.default_rng(sf)
    syms = torch.as_tensor(rng.integers(0, 256, (16, 32)), device=cuda_device)
    allsyms = _with_sync_prelude(syms, p)
    for dechirp in (False, True):
        before = cuda_tx.KERNEL_LAUNCHES
        gr, gi = cuda_tx.tx_tone_synth(allsyms, p, 0.75, dechirp=dechirp)
        assert cuda_tx.KERNEL_LAUNCHES == before + 1
        wr, wi = cuda_tx.tx_tone_synth_ref(allsyms, p, 0.75, dechirp=dechirp)
        torch.cuda.synchronize()
        assert float((gr - wr).abs().max()) <= 4e-6
        assert float((gi - wi).abs().max()) <= 4e-6


@pytest.mark.parametrize("sf", [2, 3, 4, 5, 6, 7, 8, 9])
def test_rx_kernel_matches_plain_on_card(cuda_device, sf):
    p = T.LoraParams(sf=sf)
    args = [torch.as_tensor(a, device=cuda_device)
            for a in _rx_inputs(p, sf)]
    args += [torch.ones(p.n, device=cuda_device),
             torch.zeros(p.n, device=cuda_device), p]
    before = cuda_rx.KERNEL_LAUNCHES
    gi, gp, ga = cuda_rx.rx_window_detect(*args)
    assert cuda_rx.KERNEL_LAUNCHES == before + 1
    wi, wp, wa = cuda_rx.rx_window_detect_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(gi, wi)
    assert float((gp - wp).abs().max()) <= 0.05
    assert float((ga - wa).abs().max()) <= 0.05


def test_slice_on_card_matches_cpu(cuda_device):
    """The slice through both kernels decodes what the CPU plain path
    decodes: symbols, sync word, bytes and CRC verdicts exact."""
    p = T.LoraParams(sf=7)
    rng = np.random.default_rng(1)
    pay = rng.integers(0, 256, (32, 16)).astype(np.uint8)
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        dr, di = T.modulate_dechirped(T.encode(torch.as_tensor(pay,
                                                               device=dev)), p)
        res = T.demodulate_tones(dr, di, p)
        dec, ok = T.decode(res.symbols)
        out.append([t.cpu() for t in (res.symbols, res.sync_word, dec, ok)])
    for a, b in zip(*out):
        assert torch.equal(a, b)
    assert torch.equal(out[0][2], torch.as_tensor(pay))


def test_cuda_input_never_falls_back(cuda_device):
    """On a CUDA tensor an uncovered configuration raises instead of
    running the plain version."""
    p = T.LoraParams(sf=10)
    syms = torch.zeros(1, 4, dtype=torch.int32, device=cuda_device)
    with pytest.raises(NotImplementedError, match="#2"):
        T.modulate_dechirped(syms, p)
    z = torch.zeros(1, 4 * p.n, device=cuda_device)
    with pytest.raises(NotImplementedError, match="#5"):
        T.demodulate_tones(z, z, p)


def test_rx_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    p = T.LoraParams(sf=7)
    z = torch.zeros(2, 4 * p.n, device=cuda_device)
    t = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    f = torch.zeros(2, device=cuda_device)
    m = torch.ones(p.n, device=cuda_device)
    with pytest.raises(TypeError, match="t_off"):
        cuda_rx.rx_window_detect(z, z, t.to(torch.int64), f, f, m, m, p)
    with pytest.raises(ValueError, match="contiguous"):
        zz = torch.zeros(2, 8 * p.n, device=cuda_device)[:, ::2]
        cuda_rx.rx_window_detect(zz, zz, t, f, f, m, m, p)
    with pytest.raises(ValueError, match="expected"):
        cuda_rx.rx_window_detect(z, z, t.cpu(), f, f, m, m, p)
