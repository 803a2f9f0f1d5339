"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode).  The file imports neither jax nor the JAX
package, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest`` skips tests/conftest.py, which configures jax).
Tolerances: TX IQ within 4e-6 (the kernels and their plain version read the
same table rows and round the same products); RX bins exact and dB within
0.05 (the kernels' FFT and the plain version's matmul DFT sum in different
orders).
"""
from pathlib import Path

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

VEC_DIR = Path(__file__).parent / "vectors"
OSR1_FIXTURES = [f for f in sorted(VEC_DIR.glob("ref_sf*.npz"))
                 if int(np.load(f)["osr"]) == 1]


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


@pytest.mark.parametrize("sf,bw", [(2, 125000), (5, 125000), (7, 125000),
                                   (8, 125000), (9, 125000), (10, 125000),
                                   (11, 250000), (12, 125000), (12, 500000)])
def test_tx_kernel_matches_plain_on_card(cuda_device, sf, bw):
    """Symbols over the full tone range: the dense kernel to sf9, the
    factored one above."""
    p = T.LoraParams(sf=sf, bw=bw)
    rng = np.random.default_rng(sf)
    syms = torch.as_tensor(rng.integers(0, p.n, (16, 32)), device=cuda_device)
    allsyms = _with_sync_prelude(syms, p)
    count = "DENSE_LAUNCHES" if sf <= 9 else "FACTORED_LAUNCHES"
    for dechirp in (False, True):
        before = cuda_tx.KERNEL_LAUNCHES
        own = getattr(cuda_tx, count)
        gr, gi = cuda_tx.tx_tone_synth(allsyms, p, 0.75, dechirp=dechirp)
        assert cuda_tx.KERNEL_LAUNCHES == before + 1
        assert getattr(cuda_tx, count) == own + 1
        wr, wi = cuda_tx.tx_tone_synth_ref(allsyms, p, 0.75, dechirp=dechirp)
        torch.cuda.synchronize()
        assert float((gr - wr).abs().max()) <= 4e-6
        assert float((gi - wi).abs().max()) <= 4e-6


@pytest.mark.parametrize("sf", [2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12])
def test_rx_kernel_matches_plain_on_card(cuda_device, sf):
    """The dense kernel to sf9, the large-n one above."""
    p = T.LoraParams(sf=sf)
    args = [torch.as_tensor(a, device=cuda_device)
            for a in _rx_inputs(p, sf)]
    args += [torch.ones(p.n, device=cuda_device),
             torch.zeros(p.n, device=cuda_device), p]
    count = "DENSE_LAUNCHES" if sf <= 9 else "HYBRID_LAUNCHES"
    before = cuda_rx.KERNEL_LAUNCHES
    own = getattr(cuda_rx, count)
    gi, gp, ga = cuda_rx.rx_window_detect(*args)
    assert cuda_rx.KERNEL_LAUNCHES == before + 1
    assert getattr(cuda_rx, count) == own + 1
    wi, wp, wa = cuda_rx.rx_window_detect_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(gi, wi)
    assert float((gp - wp).abs().max()) <= 0.05
    assert float((ga - wa).abs().max()) <= 0.05


def _slice_on_card_matches_cpu(cuda_device, sf, packets):
    p = T.LoraParams(sf=sf)
    rng = np.random.default_rng(1)
    pay = rng.integers(0, 256, (packets, 16)).astype(np.uint8)
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


def test_slice_on_card_matches_cpu(cuda_device):
    """The sf7 slice through both kernels decodes what the CPU plain path
    decodes: symbols, sync word, bytes and CRC verdicts exact."""
    _slice_on_card_matches_cpu(cuda_device, 7, 32)


def test_sf12_slice_on_card_matches_cpu(cuda_device):
    """The same at sf12, through the factored TX and the large-n RX."""
    _slice_on_card_matches_cpu(cuda_device, 12, 8)


@pytest.mark.parametrize("path", OSR1_FIXTURES, ids=lambda p: p.stem)
def test_demodulate_on_card_matches_cpu(cuda_device, path):
    """``demodulate`` on the card reproduces the reference's own demod
    output on its IQ, as the CPU plain path does: symbols, sync word and
    rounded timing exact; CFO within 1e-5; timing within 0.05 samples.

    The estimate runs on the raw sync chirps (PARITY.md defect 1), where
    the fractional-bin interpolation is ill-conditioned: on the Hann
    fixture a 1e-7 relative change of the input moves ``time_offset`` by
    up to 0.018 samples on the CPU alone, and the card's matmul sums in
    another order."""
    d = np.load(path)
    p = T.LoraParams(sf=int(d["sf"]), bw=int(d["bw"]), osr=1,
                     window=str(d["window"]))
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        rr, ri = T.from_complex(d["iq"][None], device=dev)
        before = cuda_rx.KERNEL_LAUNCHES
        res = T.demodulate(rr, ri, p)
        assert cuda_rx.KERNEL_LAUNCHES == before + (dev.type == "cuda")
        out.append(res)
    gpu, cpu = out
    mine = gpu.symbols.cpu().numpy()[0]
    np.testing.assert_array_equal(mine, d["demod"][: len(mine)])
    assert torch.equal(gpu.symbols.cpu(), cpu.symbols)
    assert torch.equal(gpu.sync_word.cpu(), cpu.sync_word)
    assert abs(float(gpu.cfo[0]) - float(cpu.cfo[0])) <= 1e-5
    assert abs(float(gpu.time_offset[0]) - float(cpu.time_offset[0])) <= 0.05
    assert torch.equal(torch.round(gpu.time_offset).cpu(),
                       torch.round(cpu.time_offset))


def test_cuda_input_never_falls_back(cuda_device):
    """On a CUDA tensor an uncovered configuration (osr 2) raises instead
    of running the plain version."""
    p = T.LoraParams(sf=7, osr=2)
    syms = torch.zeros(1, 4, dtype=torch.int32, device=cuda_device)
    with pytest.raises(NotImplementedError, match="#3"):
        T.modulate_dechirped(syms, p)
    z = torch.zeros(1, 4 * p.step, device=cuda_device)
    with pytest.raises(NotImplementedError, match="#6"):
        T.demodulate_tones(z, z, p)
    with pytest.raises(NotImplementedError, match="#6"):
        T.demodulate(z, z, p)


def test_tx_rows_beyond_2_31_samples(cuda_device):
    """524,289 sf12 rows, just over 2^31 samples: the kernel indexes
    samples in 64 bits.  The first and last rows match the plain version
    run on those rows alone."""
    p = T.LoraParams(sf=12)
    rows = 524289
    assert rows * p.n > 2 ** 31
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    syms = torch.randint(0, p.n, (rows, 1), generator=gen,
                         device=cuda_device, dtype=torch.int32)
    gr, gi = cuda_tx.tx_tone_synth(syms, p, dechirp=True)
    for part in (slice(0, 2), slice(rows - 2, rows)):
        wr, wi = cuda_tx.tx_tone_synth_ref(syms[part], p, dechirp=True)
        assert float((gr[part] - wr).abs().max()) <= 4e-6
        assert float((gi[part] - wi).abs().max()) <= 4e-6
    del gr, gi
    torch.cuda.empty_cache()


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
