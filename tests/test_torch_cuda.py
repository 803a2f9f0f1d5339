"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode).  It covers every kernel: the TX kernels at osr 1
and osr > 1, the RX kernels on osr-1, decimated osr > 1, halo and wide
windows up to 16384 points.  The file imports neither jax nor the JAX
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
FIXTURES = sorted(VEC_DIR.glob("ref_sf*.npz"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _rx_inputs(p, seed, packets=16, nbytes=16):
    """Real pre-dechirped packets with AWGN (sigma 0.03), t_off including
    0, +-step and osr + 1, rate ~ N(0, 1e-4), scale in [0.5, 1]."""
    rng = np.random.default_rng(seed)
    pay = rng.integers(0, 256, (packets, nbytes)).astype(np.uint8)
    dr, di = T.modulate_dechirped(T.encode(torch.as_tensor(pay)), p)  # CPU
    dr = dr.numpy() + rng.standard_normal(dr.shape).astype(np.float32) * 0.03
    di = di.numpy() + rng.standard_normal(di.shape).astype(np.float32) * 0.03
    t_off = rng.integers(-p.step, p.step + 1, packets).astype(np.int32)
    t_off[:4] = [0, p.step, -p.step, p.osr + 1]
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


@pytest.mark.parametrize("sf,bw,osr", [(9, 250000, 2), (12, 500000, 4),
                                       (7, 125000, 2), (8, 125000, 4)])
def test_tx_osr_kernel_matches_plain_on_card(cuda_device, sf, bw, osr):
    """The osr > 1 TX kernel (dense q <= 512, factored above; gated when
    osr does not divide bw_scale) on symbols over [0, 2n), so both wrap
    gates fire: IQ within 4e-6 of the plain version."""
    p = T.LoraParams(sf=sf, bw=bw, osr=osr)
    rng = np.random.default_rng(sf + osr)
    syms = torch.as_tensor(rng.integers(0, 2 * p.n, (16, 32)),
                           device=cuda_device)
    allsyms = _with_sync_prelude(syms, p)
    for dechirp in (False, True):
        before, own = cuda_tx.KERNEL_LAUNCHES, cuda_tx.OSR_LAUNCHES
        gr, gi = cuda_tx.tx_tone_synth(allsyms, p, 0.75, dechirp=dechirp)
        assert cuda_tx.KERNEL_LAUNCHES == before + 1
        assert cuda_tx.OSR_LAUNCHES == own + 1
        wr, wi = cuda_tx.tx_tone_synth_ref(allsyms, p, 0.75, dechirp=dechirp)
        torch.cuda.synchronize()
        assert float((gr - wr).abs().max()) <= 4e-6
        assert float((gi - wi).abs().max()) <= 4e-6


def _rx_kernel_vs_plain(cuda_device, p, seed, count, mults, packets=16,
                        **kw):
    args = [torch.as_tensor(a, device=cuda_device)
            for a in _rx_inputs(p, seed, packets)]
    for mr, mi in mults:
        call = args + [torch.as_tensor(mr, device=cuda_device),
                       torch.as_tensor(mi, device=cuda_device), p]
        before, own = cuda_rx.KERNEL_LAUNCHES, getattr(cuda_rx, count)
        gi, gp, ga = cuda_rx.rx_window_detect(*call, **kw)
        assert cuda_rx.KERNEL_LAUNCHES == before + 1
        assert getattr(cuda_rx, count) == own + 1
        wi, wp, wa = cuda_rx.rx_window_detect_ref(*call, **kw)
        torch.cuda.synchronize()
        assert torch.equal(gi, wi)
        assert float((gp - wp).abs().max()) <= 0.05
        assert float((ga - wa).abs().max()) <= 0.05


@pytest.mark.parametrize("osr", [2, 4])
@pytest.mark.parametrize("sf", [5, 6, 7, 8, 9, 10, 11, 12])
def test_rx_osr_kernel_matches_plain_on_card(cuda_device, sf, osr):
    """#6: decimated osr > 1 windows (t_off 0, +-step, osr + 1) through
    rx_osr, with ones and Hann: bins equal, dB within 0.05."""
    p = T.LoraParams(sf=sf, osr=osr)
    hann = T.models.modem.window_table(p.n, T.Window.HANN)
    zeros = np.zeros(p.n, np.float32)
    _rx_kernel_vs_plain(cuda_device, p, sf * 10 + osr, "OSR_LAUNCHES",
                        [(np.ones(p.n, np.float32), zeros), (hann, zeros)],
                        packets=8)


@pytest.mark.parametrize("halo", [(1, 1), (1, 0), (0, 1)])
def test_rx_halo_kernel_matches_plain_on_card(cuda_device, halo):
    """#6's halo variant on the wide sf9/BW250/osr2 grid through rx_osr."""
    p = T.LoraParams(sf=9, bw=250000, osr=2)
    w = np.repeat(T.models.modem.window_table(p.n, T.Window.HANN), 2)
    _rx_kernel_vs_plain(cuda_device, p, 91, "OSR_LAUNCHES",
                        [(w, np.zeros(p.step, np.float32))], wide=True,
                        halo=halo)


@pytest.mark.parametrize("sf,osr", [(11, 4), (12, 4)])
def test_rx_wide_kernel_matches_plain_on_card(cuda_device, sf, osr):
    """#5 at 8192 and 16384 points (the wide sf11/sf12 BW500 grids)."""
    p = T.LoraParams(sf=sf, bw=500000, osr=osr)
    _rx_kernel_vs_plain(cuda_device, p, sf, "HYBRID_LAUNCHES",
                        [(np.ones(p.step, np.float32),
                          np.zeros(p.step, np.float32))], packets=4,
                        wide=True)


@pytest.mark.parametrize("sf,bw,osr", [(9, 250000, 2), (12, 500000, 4)])
def test_demodulate_wide_on_card_matches_cpu(cuda_device, sf, bw, osr):
    """The wide pipeline through tx_osr and the n*osr-point RX decodes
    what the CPU plain path decodes: symbols, sync word, bytes exact."""
    p = T.LoraParams(sf=sf, bw=bw, osr=osr)
    pay = np.random.default_rng(sf).integers(0, 256, (8, 16)).astype(np.uint8)
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        dr, di = T.modulate_dechirped(T.encode(torch.as_tensor(pay,
                                                               device=dev)), p)
        res = T.demodulate_wide(dr, di, p)
        dec, _ = T.decode(res.symbols)
        out.append([t.cpu() for t in (res.symbols, res.sync_word, dec,
                                      res.cfo)])
    for a, b in zip(out[0][:3], out[1][:3]):
        assert torch.equal(a, b)
    assert torch.equal(out[0][2], torch.as_tensor(pay))
    assert float((out[0][3] - out[1][3]).abs().max()) <= 1e-5


@pytest.mark.parametrize("kw,rows", [
    (dict(sf=12), 524289),                         # tx_factored
    (dict(sf=12, bw=500000, osr=4), 131073),       # tx_osr
], ids=["osr1", "osr4"])
def test_tx_rows_beyond_2_31_samples(cuda_device, kw, rows):
    """Symbol rows just over 2^31 samples (524,289 sf12 rows at osr 1,
    131,073 sf12/BW500/osr4 rows): the kernels index samples in 64 bits.
    The first and last rows match the plain version run on those rows
    alone."""
    p = T.LoraParams(**kw)
    assert rows * p.step > 2 ** 31
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


@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: p.stem)
def test_demodulate_on_card_matches_cpu(cuda_device, path):
    """``demodulate`` on the card reproduces the reference's own demod
    output on its IQ (osr 2 included, through rx_osr), as the CPU plain
    path does: symbols, sync word and rounded timing exact; CFO within
    1e-5; timing within 0.05 samples.

    The estimate runs on the raw sync chirps (PARITY.md defect 1), where
    the fractional-bin interpolation is ill-conditioned: on the Hann
    fixture a 1e-7 relative change of the input moves ``time_offset`` by
    up to 0.018 samples on the CPU alone, and the card's matmul sums in
    another order."""
    d = np.load(path)
    p = T.LoraParams(sf=int(d["sf"]), bw=int(d["bw"]), osr=int(d["osr"]),
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
    """On CUDA tensors the osr-2 entry points and the wide receiver run
    kernels: every call raises its launch counters, so no plain path can
    answer them."""
    p = T.LoraParams(sf=7, osr=2)
    syms = torch.zeros(1, 4, dtype=torch.int32, device=cuda_device)
    calls = [
        (lambda: T.modulate_dechirped(syms, p), cuda_tx, "OSR_LAUNCHES"),
        (lambda: T.modulate(syms, p), cuda_tx, "OSR_LAUNCHES")]
    z = torch.zeros(1, 4 * p.step, device=cuda_device)
    calls += [(lambda: T.demodulate_tones(z, z, p), cuda_rx, "OSR_LAUNCHES"),
              (lambda: T.demodulate(z, z, p), cuda_rx, "OSR_LAUNCHES")]
    pw = T.LoraParams(sf=9, bw=250000, osr=2)
    zw = torch.zeros(1, 4 * pw.step, device=cuda_device)
    calls += [(lambda: T.demodulate_wide(zw, zw, pw), cuda_rx,
               "HYBRID_LAUNCHES")]
    for call, mod, count in calls:
        before, own = mod.KERNEL_LAUNCHES, getattr(mod, count)
        call()
        assert mod.KERNEL_LAUNCHES == before + 1
        assert getattr(mod, count) == own + 1


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
