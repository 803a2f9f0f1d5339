"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode).  It covers every kernel: the TX kernels at osr 1
and osr > 1, the RX kernels on osr-1, decimated osr > 1, halo and wide
windows up to 16384 points, the streaming scan (#7), the rotate-detect
kernel (#8), and the streaming receivers' extraction kernel and the framed
decoder kernel, which must equal their plain versions to the bit.  The
file imports neither jax nor the JAX package, so it also runs where only
PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest`` skips tests/conftest.py, which configures jax).
Tolerances: TX IQ within 4e-6 (the kernels and their plain version read the
same table rows and round the same products); RX bins exact and dB within
0.05 (the kernels' FFT and the plain version's matmul DFT sum in different
orders; the streaming scan's bins on every window with a clear peak,
power - noise > 3 dB, as tests/test_pallas_stream.py:64-71 holds them).
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import lora_sdr_lightweight_standalone_library_clean_tpu_torch as T
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.ops import (
    cuda_detect, cuda_extract, cuda_frame, cuda_rx, cuda_stream, cuda_tx)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.ops.chirp import (
    _with_sync_prelude)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.utils.spans import (
    COUNTS)

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

VEC_DIR = Path(__file__).parent / "vectors"
FIXTURES = sorted(VEC_DIR.glob("ref_sf*.npz"))


def _launches(prefix: str) -> int:
    """Launches so far of the kernels whose name starts with ``prefix``
    (``COUNTS["launch.<kernel>"]``)."""
    return sum(v for k, v in COUNTS.items()
               if k.startswith("launch." + prefix))


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
    count = "launch.tx_dense" if sf <= 9 else "launch.tx_factored"
    for dechirp in (False, True):
        before, own = _launches("tx_"), COUNTS[count]
        gr, gi = cuda_tx.tx_tone_synth(allsyms, p, 0.75, dechirp=dechirp)
        assert _launches("tx_") == before + 1
        assert COUNTS[count] == own + 1
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
    count = "launch.rx_dense" if sf <= 9 else "launch.rx_hybrid"
    before, own = _launches("rx_"), COUNTS[count]
    gi, gp, ga = cuda_rx.rx_window_detect(*args)
    assert _launches("rx_") == before + 1
    assert COUNTS[count] == own + 1
    wi, wp, wa = cuda_rx.rx_window_detect_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(gi, wi)
    assert float((gp - wp).abs().max()) <= 0.05
    assert float((ga - wa).abs().max()) <= 0.05


EDGE_TONES = 5     # rows 0-4 of _edge_windows; then impulse, zeros, NaN


def _edge_windows(n):
    """Eight windows of n samples: pure tones at bins 0, 1, n/2 - 1, n/2 and
    n - 1, an impulse at sample 0 (an exactly flat spectrum, an n-way tie),
    all zeros, and a tone at bin 3 with one NaN sample; as one float32
    (1, 8n) stream per plane, and the bins the tones must give."""
    i = np.arange(n)
    tones = [0, 1, n // 2 - 1, n // 2, n - 1]
    rows = [np.exp(2j * np.pi * k * i / n) for k in tones]
    rows += [(i == 0).astype(complex), np.zeros(n, complex)]
    nan = np.exp(2j * np.pi * 3 * i / n)
    nan[n // 3] = np.nan
    rows.append(nan)
    z = np.stack(rows).reshape(1, -1)
    return z.real.astype(np.float32), z.imag.astype(np.float32), tones


def _assert_edge_detections(got, want, tones, rows):
    """Bins equal the plain version's on every window, and the tones, the
    impulse (lowest bin of the tie), the zeros and the NaN window (the
    first NaN bin, bin 0: every bin is NaN) give the bins they must.
    Power dB within 0.05 where finite, and -inf / NaN where the plain
    version has them; noise dB on the impulse (flat, well conditioned) and
    the zeros (-inf).  A pure tone's noise dB is float32 rounding of the
    sum and is not compared."""
    gi, gp, ga = (a.reshape(-1)[:rows].cpu() for a in got)
    wi, wp, wa = (a.reshape(-1)[:rows].cpu() for a in want)
    assert torch.equal(gi, wi)
    assert gi.tolist() == tones + [0, 0, 0]
    fin = torch.isfinite(wp)
    assert torch.equal(fin, torch.isfinite(gp))
    assert float((gp[fin] - wp[fin]).abs().max()) <= 0.05
    assert torch.equal(torch.isneginf(gp), torch.isneginf(wp))
    assert bool(torch.isnan(gp[-1])) and bool(torch.isnan(wp[-1]))
    assert abs(float(ga[EDGE_TONES] - wa[EDGE_TONES])) <= 0.05
    assert bool(torch.isneginf(ga[EDGE_TONES + 1]))
    assert bool(torch.isneginf(wa[EDGE_TONES + 1]))


@pytest.mark.parametrize("n", [1 << k for k in range(2, 15)])
def test_rx_kernel_index_and_tie_cases_on_card(cuda_device, n):
    """rx_window_detect at every n from 4 to 16384 (8192 and 16384 through
    the wide grid) on windows that reach the FFT unchanged (t_off 0, rate
    0, scale 1, a multiplier of ones): the natural-bin map and the
    first-max rule of the digit-reversed FFT give the plain version's
    bins."""
    if n <= 4096:
        p, kw = T.LoraParams(sf=n.bit_length() - 1), {}
    else:
        osr = n // 4096
        p, kw = T.LoraParams(sf=12, bw=125000 * osr, osr=osr), {"wide": True}
    zr, zi, tones = _edge_windows(n)
    dev = cuda_device
    args = [torch.as_tensor(zr, device=dev), torch.as_tensor(zi, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev),
            torch.zeros(1, device=dev), torch.ones(1, device=dev),
            torch.ones(n, device=dev), torch.zeros(n, device=dev), p]
    count = "launch.rx_dense" if n <= 512 else "launch.rx_hybrid"
    own = COUNTS[count]
    got = cuda_rx.rx_window_detect(*args, **kw)
    assert COUNTS[count] == own + 1
    want = cuda_rx.rx_window_detect_ref(*args, **kw)
    torch.cuda.synchronize()
    _assert_edge_detections(got, want, tones, 8)


@pytest.mark.parametrize("sf", range(2, 13))
def test_stream_kernel_index_and_tie_cases_on_card(cuda_device, sf):
    """stream_window_detect (stride one symbol, a multiplier of ones) on
    the same eight windows and three more that lie wholly past the
    stream's end (zero padding: bin 0, -inf dB): bins equal the plain
    version's on all eleven."""
    p = T.LoraParams(sf=sf)
    n = p.n
    zr, zi, tones = _edge_windows(n)
    dev = cuda_device
    r, i = (torch.as_tensor(a[0], device=dev) for a in (zr, zi))
    ones, zeros = torch.ones(n, device=dev), torch.zeros(n, device=dev)
    got = cuda_stream.stream_window_detect(r, i, p, n, 11, ones, zeros)
    want = cuda_stream.stream_window_detect_ref(r, i, p, n, 11, ones, zeros)
    torch.cuda.synchronize()
    _assert_edge_detections(got, want, tones, 8)
    assert torch.equal(got[0], want[0])
    assert got[0][8:].tolist() == [0, 0, 0]
    for a in got[1:]:
        assert bool(torch.isneginf(a[8:]).all())


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
        before, own = _launches("tx_"), COUNTS["launch.tx_osr"]
        gr, gi = cuda_tx.tx_tone_synth(allsyms, p, 0.75, dechirp=dechirp)
        assert _launches("tx_") == before + 1
        assert COUNTS["launch.tx_osr"] == own + 1
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
        before, own = _launches("rx_"), COUNTS[count]
        gi, gp, ga = cuda_rx.rx_window_detect(*call, **kw)
        assert _launches("rx_") == before + 1
        assert COUNTS[count] == own + 1
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
    _rx_kernel_vs_plain(cuda_device, p, sf * 10 + osr, "launch.rx_osr",
                        [(np.ones(p.n, np.float32), zeros), (hann, zeros)],
                        packets=8)


@pytest.mark.parametrize("halo", [(1, 1), (1, 0), (0, 1)])
def test_rx_halo_kernel_matches_plain_on_card(cuda_device, halo):
    """#6's halo variant on the wide sf9/BW250/osr2 grid through rx_osr."""
    p = T.LoraParams(sf=9, bw=250000, osr=2)
    w = np.repeat(T.models.modem.window_table(p.n, T.Window.HANN), 2)
    _rx_kernel_vs_plain(cuda_device, p, 91, "launch.rx_osr",
                        [(w, np.zeros(p.step, np.float32))], wide=True,
                        halo=halo)


@pytest.mark.parametrize("sf,osr", [(11, 4), (12, 4)])
def test_rx_wide_kernel_matches_plain_on_card(cuda_device, sf, osr):
    """#5 at 8192 and 16384 points (the wide sf11/sf12 BW500 grids)."""
    p = T.LoraParams(sf=sf, bw=500000, osr=osr)
    _rx_kernel_vs_plain(cuda_device, p, sf, "launch.rx_hybrid",
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
        before = _launches("rx_")
        res = T.demodulate(rr, ri, p)
        assert _launches("rx_") == before + (dev.type == "cuda")
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
    calls = [(lambda: T.modulate_dechirped(syms, p), "tx_osr"),
             (lambda: T.modulate(syms, p), "tx_osr")]
    z = torch.zeros(1, 4 * p.step, device=cuda_device)
    calls += [(lambda: T.demodulate_tones(z, z, p), "rx_osr"),
              (lambda: T.demodulate(z, z, p), "rx_osr")]
    pw = T.LoraParams(sf=9, bw=250000, osr=2)
    zw = torch.zeros(1, 4 * pw.step, device=cuda_device)
    calls += [(lambda: T.demodulate_wide(zw, zw, pw), "rx_hybrid")]
    for call, kernel in calls:
        family = kernel[:3]
        before, own = _launches(family), COUNTS["launch." + kernel]
        call()
        assert _launches(family) == before + 1
        assert COUNTS["launch." + kernel] == own + 1


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


def _noisy_stream(p, symbols, seed, dev, lead=()):
    """AWGN (sigma 0.05) streams of ``symbols`` symbols with one 8-byte
    packet at sample 0 of each, made on the CPU and moved to ``dev``."""
    rng = np.random.default_rng(seed)
    length = symbols * p.step
    shape = lead + (length,)
    r = rng.standard_normal(shape).astype(np.float32) * 0.05
    i = rng.standard_normal(shape).astype(np.float32) * 0.05
    re, im = T.modulate(T.encode(torch.arange(8, dtype=torch.uint8)[None]),
                        p)
    cut = min(length, re.shape[-1])
    r[..., :cut] += 0.5 * re[0, :cut].numpy()
    i[..., :cut] += 0.5 * im[0, :cut].numpy()
    return (torch.as_tensor(r, device=dev), torch.as_tensor(i, device=dev))


def _assert_scan_matches(got, want):
    gi, gp, ga = got
    wi, wp, wa = want
    clear = (wp - wa) > 3.0
    assert bool(clear.any())
    assert torch.equal(gi[clear], wi[clear])
    assert float((gp - wp).abs().max()) <= 0.05
    assert float((ga - wa).abs().max()) <= 0.05


@pytest.mark.parametrize("sf,osr,stride_div", [
    (5, 1, 4), (7, 1, 1), (7, 1, 4), (8, 2, 2), (9, 1, 4), (9, 2, 4),
    (10, 1, 4), (11, 4, 4), (12, 1, 4), (12, 2, 2)])
def test_stream_kernel_matches_plain_on_card(cuda_device, sf, osr,
                                             stride_div):
    """#7 against its plain version: rx_dense's StreamReader to n = 512,
    rx_hybrid's above, strided reads at osr > 1."""
    p = T.LoraParams(sf=sf, osr=osr)
    stride = p.step // stride_div
    r, i = _noisy_stream(p, 21, sf * 10 + osr, cuda_device)
    windows = r.shape[-1] // stride
    before, own = _launches(""), COUNTS["launch.stream_scan"]
    got = cuda_stream.stream_window_detect(r, i, p, stride, windows)
    assert _launches("") == before + 1
    assert COUNTS["launch.stream_scan"] == own + 1
    want = cuda_stream.stream_window_detect_ref(r, i, p, stride, windows)
    torch.cuda.synchronize()
    _assert_scan_matches(got, want)


@pytest.mark.parametrize("sf,osr", [(7, 1), (8, 2), (11, 1)])
def test_stream_kernel_custom_multiplier_on_card(cuda_device, sf, osr):
    """A caller's ``dcr``/``dci`` (the scan down-chirp times a tone of 5
    bins) reaches the kernel, on rx_dense's and rx_hybrid's StreamReader:
    every clear window's bin moves by 5."""
    from lora_sdr_lightweight_standalone_library_clean_tpu_torch.parallel \
        import streaming
    p = T.LoraParams(sf=sf, osr=osr)
    stride = p.step // 4
    r, i = _noisy_stream(p, 21, sf * 10 + osr + 1, cuda_device)
    windows = r.shape[-1] // stride
    dcr, dci = streaming._scan_downchirp(p)
    dc = (dcr + 1j * dci) * np.exp(2j * np.pi * 5 * np.arange(p.n) / p.n)
    dcr, dci = (torch.as_tensor(a.astype(np.float32), device=cuda_device)
                for a in (dc.real, dc.imag))
    got = cuda_stream.stream_window_detect(r, i, p, stride, windows, dcr, dci)
    want = cuda_stream.stream_window_detect_ref(r, i, p, stride, windows,
                                                dcr, dci)
    plain = cuda_stream.stream_window_detect_ref(r, i, p, stride, windows)
    torch.cuda.synchronize()
    _assert_scan_matches(got, want)
    clear = (plain[1] - plain[2]) > 3.0
    assert torch.equal(got[0][clear], (plain[0][clear] + 5) % p.n)


def test_stream_kernel_batch_and_padding_on_card(cuda_device):
    """A (2, 3) batch of streams, with windows running past each stream's
    end (zeros, and -inf dB where a window lies wholly past it: the last
    six)."""
    p = T.LoraParams(sf=7, osr=2)
    stride = p.step // 4
    r, i = _noisy_stream(p, 9, 5, cuda_device, lead=(2, 3))
    inside = r.shape[-1] // stride
    windows = inside + 6
    got = cuda_stream.stream_window_detect(r, i, p, stride, windows)
    want = cuda_stream.stream_window_detect_ref(r, i, p, stride, windows)
    torch.cuda.synchronize()
    assert got[0].shape == (2, 3, windows)
    past = slice(inside, windows)
    for a, b in zip(got, want):
        assert torch.equal(a[..., past], b[..., past])
    assert bool(torch.isneginf(got[1][..., past]).all())
    live = slice(0, inside)
    _assert_scan_matches(*[[a[..., live] for a in x] for x in (got, want)])


def test_stream_kernel_beyond_2_31_samples(cuda_device):
    """One stream of 2^31 + 2^20 samples (sf7, stride one symbol) with a
    packet at its start and one at its end: the kernel's 64-bit offsets
    give the plain version's first and last windows."""
    p = T.LoraParams(sf=7)
    length = 2 ** 31 + 2 ** 20
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    r = torch.randn(length, generator=gen, device=cuda_device) * 0.05
    i = torch.randn(length, generator=gen, device=cuda_device) * 0.05
    re, im = T.modulate(T.encode(torch.arange(8, dtype=torch.uint8,
                                              device=cuda_device)[None]), p)
    plen = re.shape[-1]
    for lo in (0, length - plen):
        r[lo:lo + plen] += re[0]
        i[lo:lo + plen] += im[0]
    windows = length // p.step
    got = cuda_stream.stream_window_detect(r, i, p, p.step, windows)
    k = plen // p.step + 2
    want_head = cuda_stream.stream_window_detect_ref(
        r[:k * p.step], i[:k * p.step], p, p.step, k)
    tail = (windows - k) * p.step
    want_tail = cuda_stream.stream_window_detect_ref(
        r[tail:], i[tail:], p, p.step, k)
    torch.cuda.synchronize()
    _assert_scan_matches([a[:k] for a in got], want_head)
    _assert_scan_matches([a[-k:] for a in got], want_tail)
    del r, i
    torch.cuda.empty_cache()


EXTRACT_CONFIGS = {"sf7": dict(sf=7), "sf12": dict(sf=12),
                   "sf7-osr2": dict(sf=7, osr=2),
                   "sf9-bw250-osr2": dict(sf=9, bw=250000, osr=2)}


def _extract_case(p, symbols, dev, seed):
    """A noisy (len,) stream and, sorted as the receivers sort them, odd
    starts, a row ending on the last sample, and repeated starts at 0 (the
    sentinel rows), int64 on ``dev``."""
    rng = np.random.default_rng(seed)
    plen = symbols * p.step
    length = plen + 40 * p.step + 7
    sr = torch.as_tensor(rng.standard_normal(length).astype(np.float32),
                         device=dev)
    si = torch.as_tensor(rng.standard_normal(length).astype(np.float32),
                         device=dev)
    last = length - plen
    odd = np.sort(rng.integers(0, last, 24) | 1)
    pos = np.concatenate([odd, [odd[-1], last - 2, last], [0] * 5])
    return sr, si, torch.as_tensor(pos, dtype=torch.int64, device=dev), plen


@pytest.mark.parametrize("config", sorted(EXTRACT_CONFIGS))
def test_extract_kernel_equals_plain_on_card(cuda_device, config):
    """The extraction kernel's rows are the plain steps' to the bit (no
    tolerance): odd starts, a repeated start, a row that ends on the last
    sample, and sentinel rows at 0; one launch."""
    p = T.LoraParams(**EXTRACT_CONFIGS[config])
    sr, si, pos, plen = _extract_case(p, 35 if p.step < 4096 else 4,
                                      cuda_device, p.sf)
    before = COUNTS["launch.extract_dechirp"]
    dr, di = cuda_extract.extract_dechirp(sr, si, pos, plen, p)
    assert COUNTS["launch.extract_dechirp"] == before + 1
    wr, wi = cuda_extract.extract_dechirp_ref(sr, si, pos, plen, p)
    torch.cuda.synchronize()
    assert dr.shape == (pos.shape[0], plen)
    assert torch.equal(dr, wr) and torch.equal(di, wi)


def test_extract_kernel_no_rows_on_card(cuda_device):
    """K = 0 launches nothing and returns empty (0, plen) planes."""
    p = T.LoraParams(sf=7)
    z = torch.zeros(8 * p.step, device=cuda_device)
    pos = torch.zeros(0, dtype=torch.int64, device=cuda_device)
    before = COUNTS["launch.extract_dechirp"]
    dr, di = cuda_extract.extract_dechirp(z, z, pos, 4 * p.step, p)
    assert COUNTS["launch.extract_dechirp"] == before
    assert dr.shape == di.shape == (0, 4 * p.step)
    assert dr.device == di.device == z.device


def test_extract_kernel_beyond_2_31_samples(cuda_device):
    """A stream of 2^31 + 2^20 samples with rows at 0, just past 2^31 (odd)
    and ending on the last sample: the kernel's 64-bit offsets give the
    plain steps' rows, each run on its own samples."""
    p = T.LoraParams(sf=7)
    length = 2 ** 31 + 2 ** 20
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    r = torch.randn(length, generator=gen, device=cuda_device)
    i = torch.randn(length, generator=gen, device=cuda_device)
    plen = 68 * p.step
    pos = torch.tensor([0, 2 ** 31 + 3, length - plen], dtype=torch.int64,
                       device=cuda_device)
    dr, di = cuda_extract.extract_dechirp(r, i, pos, plen, p)
    zero = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    for k, a in enumerate(pos.tolist()):
        row = slice(a, a + plen)
        wr, wi = cuda_extract.extract_dechirp_ref(r[row], i[row], zero, plen,
                                                  p)
        assert torch.equal(dr[k], wr[0]) and torch.equal(di[k], wi[0]), a
    del r, i
    torch.cuda.empty_cache()


def test_extract_kernel_rejects_what_it_does_not_take(cuda_device):
    """Wrong dtype, device or shape of any input, and a row length that is
    not a multiple of step, raise InvalidArgumentError."""
    p = T.LoraParams(sf=7)
    plen = 4 * p.step
    z = torch.zeros(8 * p.step, device=cuda_device)
    pos = torch.tensor([0, 3], device=cuda_device)
    bad = {
        "ext_r dtype": (z.double(), z, pos, plen),
        "ext_i dtype": (z, z.half(), pos, plen),
        "ext_i device": (z, z.cpu(), pos, plen),
        "ext_r shape": (z.reshape(8, p.step), z, pos, plen),
        "ext_i shape": (z, z[:-1], pos, plen),
        "ext_i strided": (z, torch.zeros(16 * p.step,
                                         device=cuda_device)[::2], pos, plen),
        "pos dtype": (z, z, pos.int(), plen),
        "pos device": (z, z, pos.cpu(), plen),
        "pos shape": (z, z, pos[None], plen),
        "plen": (z, z, pos, plen + 4),
    }
    for what, args in bad.items():
        try:
            cuda_extract.extract_dechirp(*args, p)
        except T.errors.InvalidArgumentError:
            continue
        pytest.fail(f"{what}: no InvalidArgumentError")


@pytest.mark.parametrize("sf", [2, 3, 4, 5, 6, 7, 8, 9])
def test_rotate_detect_kernel_matches_plain_on_card(cuda_device, sf):
    """#8 against its plain version on tones with |cfo| up to half a bin,
    AWGN, rotation rates ~ N(0, 1e-3), windowed by ones and by Hann."""
    n = 1 << sf
    rng = np.random.default_rng(sf)
    b, s = 16, 10
    k = rng.integers(0, n, (b, s, 1)) + rng.uniform(-0.5, 0.5, (b, s, 1))
    z = np.exp(2j * np.pi * k * np.arange(n) / n)
    z = z + (rng.standard_normal(z.shape)
             + 1j * rng.standard_normal(z.shape)) * 0.1
    rate = torch.as_tensor((rng.standard_normal(b) * 1e-3).astype(np.float32),
                           device=cuda_device)
    start = torch.as_tensor(rng.standard_normal((b, s)).astype(np.float32),
                            device=cuda_device)
    hann = T.models.modem.window_table(n, T.Window.HANN)
    for w in (np.ones(n, np.float32), hann):
        zr = torch.as_tensor((z.real * w).astype(np.float32),
                             device=cuda_device)
        zi = torch.as_tensor((z.imag * w).astype(np.float32),
                             device=cuda_device)
        before, own = _launches(""), COUNTS["launch.rotate_detect"]
        gi, gp, ga = cuda_detect.fused_rotate_detect(zr, zi, rate, start)
        assert _launches("") == before + 1
        assert COUNTS["launch.rotate_detect"] == own + 1
        wi, wp, wa = cuda_detect.fused_rotate_detect_ref(zr, zi, rate, start)
        torch.cuda.synchronize()
        assert torch.equal(gi, wi)
        assert float((gp - wp).abs().max()) <= 0.05
        assert float((ga - wa).abs().max()) <= 0.05


def test_backend_pallas_on_card_matches_cpu(cuda_device):
    """demodulate_tones and demodulate with backend="pallas" launch the
    rotate-detect kernel and not the fused RX.  The tones route gives the
    CPU plain route's symbols and sync words; the full RX gives the card's
    auto route's (on the reference's own noise-free modulation its raw-chirp
    estimate is ill-conditioned, PARITY.md defect 1, so card and CPU
    estimates may round to other timings)."""
    p = T.LoraParams(sf=7)
    pay = np.random.default_rng(2).integers(0, 256, (8, 16)).astype(np.uint8)
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        syms = T.encode(torch.as_tensor(pay, device=dev))
        re, im = T.modulate(syms, p)
        dr, di = T.dechirp(re, im, p)
        det, rx = COUNTS["launch.rotate_detect"], _launches("rx_")
        tones = T.demodulate_tones(dr, di, p, backend="pallas")
        full = T.demodulate(re, im, p, backend="pallas")
        on_card = dev.type == "cuda"
        assert COUNTS["launch.rotate_detect"] == det + 2 * on_card
        assert _launches("rx_") == rx
        auto = T.demodulate(re, im, p)
        assert torch.equal(full.symbols, auto.symbols)
        assert torch.equal(full.sync_word, auto.sync_word)
        out.append([t.cpu() for t in (tones.symbols, tones.sync_word)])
    for a, b in zip(*out):
        assert torch.equal(a, b)
    dec, _ = T.decode(out[0][0])
    assert torch.equal(dec, torch.as_tensor(pay))


def test_stream_and_detect_kernels_reject_outside_their_domain(cuda_device):
    """#7 takes osr | stride | step; #8 takes n <= 512 and names
    backend='auto' for sf10-12."""
    p = T.LoraParams(sf=7, osr=2)
    z = torch.zeros(4 * p.step, device=cuda_device)
    for stride in (3, 96):          # osr does not divide it; not | step
        with pytest.raises(T.errors.InvalidArgumentError, match="stride"):
            cuda_stream.stream_window_detect(z, z, p, stride, 4)
    zz = torch.zeros(1, 2, 1024, device=cuda_device)
    f = torch.zeros(1, device=cuda_device)
    with pytest.raises(T.errors.InvalidArgumentError, match="auto"):
        cuda_detect.fused_rotate_detect(zz, zz, f, torch.zeros(
            1, 2, device=cuda_device))
    p10 = T.LoraParams(sf=10)
    z10 = torch.zeros(1, 4 * p10.step, device=cuda_device)
    with pytest.raises(T.errors.InvalidArgumentError, match="auto"):
        T.demodulate_tones(z10, z10, p10, backend="pallas")


def test_receive_stream_on_card_matches_cpu(cuda_device):
    """The streaming receiver through #7 and the RX kernels recovers what
    the CPU plain path recovers: starts, bytes, CRC verdicts, sync words."""
    p = T.LoraParams(sf=7)
    rng = np.random.default_rng(4)
    plen = T.packet_samples(p, 16)
    offsets = [512, 5003, 9000, 11777, 20011]
    pay = rng.integers(0, 256, (len(offsets), 8)).astype(np.uint8)
    re, im = T.modulate(T.encode(torch.as_tensor(pay)), p)
    sr = rng.standard_normal(32768).astype(np.float32) * 0.05
    si = rng.standard_normal(32768).astype(np.float32) * 0.05
    for k, g in enumerate(offsets):
        sr[g:g + plen] += re[k].numpy()
        si[g:g + plen] += im[k].numpy()
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        before = COUNTS["launch.stream_scan"]
        pk, _ = T.receive_stream(torch.as_tensor(sr, device=dev),
                                 torch.as_tensor(si, device=dev), p,
                                 payload_symbols=16, max_packets=8)
        assert COUNTS["launch.stream_scan"] == before + (dev.type == "cuda")
        out.append(pk)
    gpu, cpu = out
    for f in ("payload", "crc_ok", "valid", "start", "sync_word",
              "n_candidates", "n_dropped"):
        assert torch.equal(getattr(gpu, f).cpu(), getattr(cpu, f)), f
    assert gpu.start[gpu.valid].tolist() == offsets
    assert torch.equal(gpu.payload[:5].cpu(), torch.as_tensor(pay))


@pytest.mark.parametrize("rdd", [1, 2, 3, 4])
@pytest.mark.parametrize("sf", [7, 8, 9, 10, 11, 12])
def test_framed_roundtrip_on_card_matches_cpu(cuda_device, sf, rdd):
    """``encode_frame -> modulate_dechirped -> demodulate_tones ->
    decode_frame_padded`` on the card (TX and RX kernels) gives the CPU
    plain path's symbols and FrameResult, mixed lengths 1-12 at
    ``max_payload_len`` 12, and every payload back."""
    p = T.LoraParams(sf=sf, cr=f"4/{4 + rdd}")
    rng = np.random.default_rng(sf * 10 + rdd)
    lengths = rng.integers(1, 13, 8)
    pays = [rng.integers(0, 256, n).astype(np.uint8) for n in lengths]
    s_max = T.max_frame_symbols(p, 12)
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        rows = []
        for pay in pays:
            s = T.encode_frame(torch.as_tensor(pay, device=dev)[None], p)
            rows.append(torch.nn.functional.pad(s, (0, s_max - s.shape[-1])))
        syms = torch.cat(rows)
        dr, di = T.modulate_dechirped(syms, p)
        res = T.demodulate_tones(dr, di, p)
        out.append((syms, res.symbols,
                    T.decode_frame_padded(res.symbols, p, 12)))
    (gs, gsym, gfr), (cs, csym, cfr) = out
    assert torch.equal(gs.cpu(), cs) and torch.equal(gsym.cpu(), csym)
    for f in gfr._fields:
        assert torch.equal(getattr(gfr, f).cpu(), getattr(cfr, f)), f
    assert cfr.hdr_ok.all() and cfr.crc_ok.all()
    assert cfr.length.tolist() == lengths.tolist()
    for k, pay in enumerate(pays):
        assert cfr.payload[k, :len(pay)].tolist() == pay.tolist()


def test_receive_stream_frames_on_card_matches_cpu(cuda_device):
    """The framed streaming receiver through #7 and the RX kernels recovers
    what the CPU plain path recovers, mixed lengths at any offset."""
    p = T.LoraParams(sf=7, cr="4/8")
    rng = np.random.default_rng(6)
    sr = rng.standard_normal(49152).astype(np.float32) * 0.05
    si = rng.standard_normal(49152).astype(np.float32) * 0.05
    offsets = [1000, 9000, 17003, 30011]
    pays = [rng.integers(0, 256, n).astype(np.uint8) for n in (3, 16, 9, 1)]
    for g, pay in zip(offsets, pays):
        re, im = T.modulate(T.encode_frame(torch.as_tensor(pay)[None], p), p)
        sr[g:g + re.shape[-1]] += re[0].numpy()
        si[g:g + re.shape[-1]] += im[0].numpy()
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        fr, _ = T.receive_stream_frames(torch.as_tensor(sr, device=dev),
                                        torch.as_tensor(si, device=dev), p,
                                        max_payload_len=16, max_packets=8)
        out.append(fr)
    gpu, cpu = out
    for f in ("payload", "length", "hdr_ok", "crc_ok", "valid", "start",
              "sync_word", "n_err", "n_candidates", "n_dropped"):
        assert torch.equal(getattr(gpu, f).cpu(), getattr(cpu, f)), f
    good = (cpu.valid & cpu.crc_ok).numpy()
    assert cpu.start.numpy()[good].tolist() == offsets
    for k, pay in zip(np.nonzero(good)[0], pays):
        assert cpu.payload[k, :len(pay)].tolist() == pay.tolist()


CRS = {1: "4/5", 2: "4/6", 3: "4/7", 4: "4/8"}


def _frame_rows(p, max_len, crc, rng, count=64):
    """int32 (count + 64, s_need) CPU rows for the framed decoder: frames
    of random lengths up to the bound, frames with a body symbol moved by
    n/2 after their CRC was made, headers with another coding rate or the
    other CRC flag, length 0, lengths past the bound (cut to the row), and
    random int32 symbols in [0, 2^16)."""
    s_need = T.max_frame_symbols(p, max_len, crc)

    def frames(q, lengths, with_crc=crc):
        rows = []
        for n in lengths:
            pay = torch.as_tensor(rng.integers(0, 256, (1, int(n))).astype(
                np.uint8))
            f = T.encode_frame(pay, q, crc=with_crc)[0].numpy()[:s_need]
            rows.append(np.concatenate(
                [f, rng.integers(0, p.n, s_need - f.shape[0])]))
        return rows
    real = frames(p, rng.integers(1, max_len + 1, count))
    moved = frames(p, rng.integers(1, max_len + 1, 16))
    for r in moved:
        if s_need > 8:
            r[rng.integers(8, s_need)] ^= p.n // 2
    other = T.LoraParams(sf=p.sf, cr=CRS[p.rdd % 4 + 1])
    rows = (real + moved + frames(other, rng.integers(1, max_len + 1, 8))
            + frames(p, rng.integers(1, max_len + 1, 4), not crc)
            + frames(p, [0] * 4)
            + frames(p, rng.integers(min(max_len + 1, 255), 256, 8))
            + [rng.integers(0, 2 ** 16, s_need) for _ in range(24)])
    return torch.as_tensor(np.stack(rows).astype(np.int32))


def _same_result(got, want):
    for f in want._fields:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and g.shape == w.shape, f
        assert torch.equal(g.cpu(), w), f


@pytest.mark.parametrize("crc", [True, False])
@pytest.mark.parametrize("rdd", [1, 2, 3, 4])
@pytest.mark.parametrize("sf", [7, 8, 9, 10, 11, 12])
def test_decode_frame_kernel_equals_plain_on_card(cuda_device, sf, rdd, crc):
    """The framed-decoder kernel gives the CPU plain path's payload, length,
    hdr_ok, crc_ok and n_err to the bit on real, corrupted, wrong-rate,
    empty, oversize and random rows, at every bound of 1, 12, 51, 235 and
    255 bytes; one launch a call."""
    p = T.LoraParams(sf=sf, cr=CRS[rdd])
    rng = np.random.default_rng(sf * 100 + rdd * 10 + crc)
    for max_len in (1, 12, 51, 235, 255):
        rows = _frame_rows(p, max_len, crc, rng)
        want = T.decode_frame_padded(rows, p, max_len, crc)
        before = COUNTS["launch.decode_frame"]
        got = T.decode_frame_padded(rows.to(cuda_device), p, max_len, crc)
        assert COUNTS["launch.decode_frame"] == before + 1
        _same_result(got, want)
        assert want.crc_ok.any() and (~want.hdr_ok).any()


@pytest.mark.parametrize("k", [0, 1, 33, 12660])
def test_decode_frame_kernel_row_counts_on_card(cuda_device, k):
    """K rows at GF7's profile and bound (sf7, CR 4/5, 235 B): the CPU
    plain path's outputs; K = 0 launches nothing and returns empty
    outputs on the card."""
    p = T.LoraParams(sf=7, cr="4/5")
    rng = np.random.default_rng(k)
    rows = _frame_rows(p, 235, True, rng)
    rows = rows[rng.integers(0, rows.shape[0], k)]
    want = T.decode_frame_padded(rows, p, 235)
    before = COUNTS["launch.decode_frame"]
    got = T.decode_frame_padded(rows.to(cuda_device), p, 235)
    assert COUNTS["launch.decode_frame"] == before + (1 if k else 0)
    assert got.payload.device == rows.to(cuda_device).device
    _same_result(got, want)


def test_decode_frame_kernel_batch_axes_and_slices_on_card(cuda_device):
    """Leading batch axes are flattened and restored, a non-contiguous
    slice of wider rows (``decode_frame``'s ``s[..., :need]``) and rows
    wider than the bound decode as the CPU plain path decodes them, and
    ``decode_frame`` sizes one frame to its header on the card."""
    p = T.LoraParams(sf=8, cr="4/6")
    rng = np.random.default_rng(8)
    rows = _frame_rows(p, 51, True, rng, count=56)
    wide = torch.cat([rows, torch.as_tensor(
        rng.integers(0, p.n, (120, 13)).astype(np.int32))], dim=1)
    for x in (rows.reshape(4, 30, -1), rows.reshape(2, 3, 20, -1), wide,
              wide.reshape(6, 20, -1)):
        _same_result(T.decode_frame_padded(x.to(cuda_device), p, 51),
                     T.decode_frame_padded(x, p, 51))
    cut = wide.to(cuda_device)[:, :rows.shape[1]]
    assert not cut.is_contiguous()
    _same_result(T.decode_frame_padded(cut, p, 51),
                 T.decode_frame_padded(rows, p, 51))
    pay = torch.as_tensor(rng.integers(0, 256, (1, 17)).astype(np.uint8))
    s = T.encode_frame(pay, p)[0]
    s = torch.cat([s, torch.zeros(9, dtype=s.dtype)])
    got = T.decode_frame(s.to(cuda_device), p)
    _same_result(got, T.decode_frame(s, p))
    assert got.payload.cpu().tolist() == pay[0].tolist()


def test_decode_frame_kernel_rejects_what_it_does_not_take(cuda_device):
    """A CPU tensor, another dtype, no axis, too few symbols, a bound out of
    range and sf below 7 raise InvalidArgumentError at the kernel's
    wrapper."""
    p = T.LoraParams(sf=7)
    s_need = T.max_frame_symbols(p, 12)
    z = torch.zeros(4, s_need, dtype=torch.int32, device=cuda_device)
    bad = {
        "cpu": (z.cpu(), p, 12),
        "dtype": (z.long(), p, 12),
        "scalar": (z[0, 0], p, 12),
        "short": (z[:, :-1], p, 12),
        "negative bound": (z, p, -1),
        "bound": (z, p, cuda_frame.MAX_LEN + 1),
        "bool bound": (z, p, True),
        "sf": (z, T.LoraParams(sf=6), 12),
    }
    for what, args in bad.items():
        try:
            cuda_frame.decode_frame(*args)
        except T.errors.InvalidArgumentError:
            continue
        pytest.fail(f"{what}: no InvalidArgumentError")


def test_receive_stream_frames_waits_for_nothing_on_card(cuda_device):
    """A warmed one-card ``receive_stream_frames`` call on GF7-like input
    (sf7, CR 4/5, frames of 13-235 B in noise, stride 32, gate 4 dB)
    makes no synchronising call: under ``set_sync_debug_mode("error")``
    it raises nothing, launches the decoder kernel once, and recovers the
    frames the CPU plain path recovers."""
    p = T.LoraParams(sf=7, cr="4/5")
    rng = np.random.default_rng(7)
    plen = T.packet_samples(p, T.max_frame_symbols(p, 235))
    pitch = plen + 2 * p.step
    frames = 6
    sr = rng.standard_normal(frames * pitch + 4096).astype(np.float32) * .05
    si = rng.standard_normal(sr.shape[0]).astype(np.float32) * .05
    for k in range(frames):
        pay = rng.integers(0, 256, rng.integers(13, 236)).astype(np.uint8)
        re, im = T.modulate(T.encode_frame(torch.as_tensor(pay)[None], p), p)
        g = k * pitch + int(rng.integers(0, p.step))
        sr[g:g + re.shape[-1]] += re[0].numpy()
        si[g:g + re.shape[-1]] += im[0].numpy()
    kw = dict(max_payload_len=235, max_packets=4 * frames, stride=32,
              power_gate_db=4.0)
    r, i = (torch.as_tensor(x, device=cuda_device) for x in (sr, si))
    T.receive_stream_frames(r, i, p, **kw)          # tables, library
    torch.cuda.synchronize()
    before = COUNTS["launch.decode_frame"]
    saved = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gpu, _ = T.receive_stream_frames(r, i, p, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(saved)
    assert COUNTS["launch.decode_frame"] == before + 1
    cpu, _ = T.receive_stream_frames(torch.as_tensor(sr),
                                     torch.as_tensor(si), p, **kw)
    for f in ("payload", "length", "hdr_ok", "crc_ok", "valid", "start",
              "n_err", "n_candidates", "n_dropped"):
        assert torch.equal(getattr(gpu, f).cpu(), getattr(cpu, f)), f
    assert int((cpu.valid & cpu.crc_ok).sum()) == frames


def _tf32_run(cuda_device):
    outs = []
    for path in FIXTURES:
        d = np.load(path)
        p = T.LoraParams(sf=int(d["sf"]), bw=int(d["bw"]), osr=int(d["osr"]),
                         window=str(d["window"]))
        rr, ri = T.from_complex(d["iq"][None], device=cuda_device)
        outs.append(T.demodulate(rr, ri, p))
    p = T.LoraParams(sf=12)
    pay = np.random.default_rng(12).integers(0, 256, (64, 16)).astype(
        np.uint8)
    re, im = T.modulate(T.encode(torch.as_tensor(pay, device=cuda_device)), p)
    outs.append(T.demodulate(re, im, p))
    return [tuple(t.cpu() for t in (r.symbols, r.sync_word, r.cfo,
                                    r.time_offset)) for r in outs]


@pytest.mark.parametrize("how", ["allow_tf32", "precision"])
def test_tf32_switch_changes_nothing_and_is_restored(cuda_device, how):
    """With the caller's TF32 on, the eight C-reference fixtures and a
    64-packet sf12 slice through ``demodulate`` (estimator and RX kernels)
    give exactly what they give with it off: symbols, sync words, CFO and
    timing identical; the caller's switch is as it was afterwards."""
    assert len(FIXTURES) == 8
    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("highest")
        want = _tf32_run(cuda_device)
        if how == "allow_tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
        else:
            torch.set_float32_matmul_precision("high")
        got = _tf32_run(cuda_device)
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(saved)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert torch.equal(a, b)
    assert sum(int(s[0].numel()) for s in got) > 0
