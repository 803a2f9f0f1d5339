"""The port's two kernel modules (ops/cuda_tx.py, ops/cuda_rx.py) and their
build (utils/cuda_build.py).

On the CPU each wrapper runs its kernel's plain PyTorch version; those are
held here to the JAX package's Pallas kernels run in interpret mode, with
the tolerances of tests/test_pallas.py.  The CUDA kernels themselves run
only on a card: tests/test_torch_cuda.py compares them with their plain
versions there, and ``chip_smoke.py`` does the same at the main path's
shapes.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")

import torch  # noqa: E402

import lora_sdr_lightweight_standalone_library_clean_tpu as J  # noqa: E402
from lora_sdr_lightweight_standalone_library_clean_tpu.ops import (  # noqa: E402
    pallas_rx, pallas_tx)
from lora_sdr_lightweight_standalone_library_clean_tpu.ops.chirp import (  # noqa: E402
    _with_sync_prelude as j_prelude)

import lora_sdr_lightweight_standalone_library_clean_tpu_torch as T  # noqa: E402
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.ops import (  # noqa: E402
    cuda_rx, cuda_tx, dft)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.ops.chirp import (  # noqa: E402
    _with_sync_prelude)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.utils import (  # noqa: E402
    cuda_build, errors as terrors)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.utils.spans import (  # noqa: E402
    COUNTS)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT = "lora_sdr_lightweight_standalone_library_clean_tpu_torch"


def _tx_inputs(sf, seed, packets=4, nsym=10):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (packets, nsym)).astype(np.int32)


def _rx_inputs(sf, seed, packets=6):
    """Real packets with AWGN, t_off including 0 and +-step, small CFO
    rates and scales (tests/test_pallas.py:94-107)."""
    p = J.LoraParams(sf=sf)
    n, step = p.n, p.step
    rng = np.random.default_rng(seed)
    payloads = rng.integers(0, 256, (packets, 8)).astype(np.uint8)
    re, im = J.modulate(J.encode(payloads), p)
    dr, di = J.dechirp(re, im, p)
    dr = np.asarray(dr) + rng.standard_normal(dr.shape).astype(np.float32) * 0.03
    di = np.asarray(di) + rng.standard_normal(di.shape).astype(np.float32) * 0.03
    t_off = rng.integers(-step, step + 1, packets).astype(np.int32)
    t_off[:3] = [0, step, -step]
    rate = (rng.standard_normal(packets) * 1e-4).astype(np.float32)
    scale = rng.uniform(0.5, 1.0, packets).astype(np.float32)
    return p, n, dr, di, t_off, rate, scale


# ---------------------------------------------------------------------------
# TX: tx_tone_synth_ref against ops/pallas_tx.py::tx_tone_synth (interpret)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dechirp,atol", [(False, 2e-6), (True, 4e-6)])
@pytest.mark.parametrize("sf", [5, 7, 8, 9])
def test_tx_ref_matches_pallas_tx(sf, dechirp, atol):
    """IQ within 2e-6 (4e-6 with the folded down-chirp), the tolerances of
    tests/test_pallas.py:290-302: the same table rows, folded in another
    float order."""
    syms = _tx_inputs(sf, sf)
    jp = J.LoraParams(sf=sf)
    jall = j_prelude(jnp.asarray(syms), jp)
    wr, wi = pallas_tx.tx_tone_synth(jall, jp, amplitude=0.75,
                                     dechirp=dechirp, interpret=True)
    tp = T.LoraParams(sf=sf)
    gr, gi = cuda_tx.tx_tone_synth_ref(
        _with_sync_prelude(torch.as_tensor(syms), tp), tp, amplitude=0.75,
        dechirp=dechirp)
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), atol=atol, rtol=0)
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), atol=atol, rtol=0)


@pytest.mark.parametrize("bw", [250000, 500000])
def test_tx_ref_even_bw_scale_matches_pallas_tx(bw):
    """bw_scale 2 and 4: no alternating row sign; IQ within 2e-6."""
    syms = _tx_inputs(7, 11)
    jp = J.LoraParams(sf=7, bw=bw)
    wr, wi = pallas_tx.tx_tone_synth(j_prelude(jnp.asarray(syms), jp), jp,
                                     interpret=True)
    tp = T.LoraParams(sf=7, bw=bw)
    gr, gi = cuda_tx.tx_tone_synth_ref(
        _with_sync_prelude(torch.as_tensor(syms), tp), tp)
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), atol=2e-6, rtol=0)
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), atol=2e-6, rtol=0)


def _launches() -> int:
    """Launches of every hand-written kernel so far (``COUNTS``)."""
    return sum(v for k, v in COUNTS.items() if k.startswith("launch."))


def test_tx_wrapper_on_cpu_runs_plain_version():
    """A CPU tensor takes the plain version (bit-equal) and launches
    nothing."""
    p = T.LoraParams(sf=7)
    allsyms = _with_sync_prelude(torch.as_tensor(_tx_inputs(7, 1)), p)
    before = _launches()
    gr, gi = cuda_tx.tx_tone_synth(allsyms, p, dechirp=True)
    wr, wi = cuda_tx.tx_tone_synth_ref(allsyms, p, dechirp=True)
    assert _launches() == before
    assert torch.equal(gr, wr) and torch.equal(gi, wi)


# ---------------------------------------------------------------------------
# RX: rx_window_detect_ref against ops/pallas_rx.py::rx_window_detect
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sf", [5, 7, 8, 9])
def test_rx_ref_matches_pallas_rx(sf):
    """Bins exact; dB within rtol 1e-3, atol 0.05 (tests/test_pallas.py:
    127-131): the DFTs sum in different orders."""
    p, n, dr, di, t_off, rate, scale = _rx_inputs(sf, sf)
    jp = J.LoraParams(sf=sf)
    wi_, wp, wa = pallas_rx.rx_window_detect(
        jnp.asarray(dr), jnp.asarray(di), jnp.asarray(t_off),
        jnp.asarray(rate), jnp.asarray(scale), jnp.ones(n, jnp.float32),
        jnp.zeros(n, jnp.float32), jp, interpret=True)
    tp = T.LoraParams(sf=sf)
    gi_, gp, ga = cuda_rx.rx_window_detect_ref(
        *(torch.as_tensor(a) for a in (dr, di, t_off, rate, scale)),
        torch.ones(n), torch.zeros(n), tp)
    np.testing.assert_array_equal(gi_.numpy(), np.asarray(wi_))
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=1e-3,
                               atol=0.05)
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), rtol=1e-3,
                               atol=0.05)


def test_rx_ref_with_window_multiplier_matches_pallas_rx():
    """A Hann multiplier (the windowed tones path): bins exact, dB within
    rtol 1e-3, atol 0.05."""
    p, n, dr, di, t_off, rate, scale = _rx_inputs(7, 21)
    win = J.models.modem.window_table(n, J.Window.HANN)
    jp = J.LoraParams(sf=7)
    wi_, wp, _ = pallas_rx.rx_window_detect(
        jnp.asarray(dr), jnp.asarray(di), jnp.asarray(t_off),
        jnp.asarray(rate), jnp.asarray(scale), jnp.asarray(win),
        jnp.zeros(n, jnp.float32), jp, interpret=True)
    gi_, gp, _ = cuda_rx.rx_window_detect_ref(
        *(torch.as_tensor(a) for a in (dr, di, t_off, rate, scale)),
        torch.as_tensor(win), torch.zeros(n), T.LoraParams(sf=7))
    np.testing.assert_array_equal(gi_.numpy(), np.asarray(wi_))
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=1e-3,
                               atol=0.05)


def test_rx_ref_ties_go_to_the_first_bin():
    """All-zero windows tie every bin: the first (bin 0) wins, as in the
    reference (LoRaDetector.hpp:53)."""
    p = T.LoraParams(sf=7)
    z = torch.zeros(2, 4 * p.n)
    idx, _, _ = cuda_rx.rx_window_detect_ref(
        z, z, torch.tensor([0, 3], dtype=torch.int32), torch.zeros(2),
        torch.ones(2), torch.ones(p.n), torch.zeros(p.n), p)
    assert idx.dtype == torch.int32
    assert torch.equal(idx, torch.zeros(2, 4, dtype=torch.int32))


def test_rx_wrapper_on_cpu_runs_plain_version():
    p, n, dr, di, t_off, rate, scale = _rx_inputs(7, 5)
    args = [torch.as_tensor(a) for a in (dr, di, t_off, rate, scale)]
    args += [torch.ones(n), torch.zeros(n), T.LoraParams(sf=7)]
    before = _launches()
    got = cuda_rx.rx_window_detect(*args)
    want = cuda_rx.rx_window_detect_ref(*args)
    assert _launches() == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_rx_fft_twiddles_are_the_dft_matrix_row():
    """The kernels' FFT twiddles exp(-2j*pi*k/n) are bit-equal to row 1 of
    the dense DFT matrix: the matrix itself to n = 512, and to n = 4096
    its row 1 computed as ``_dft_mats`` computes it, without the (n, n)
    matrix."""
    for n in (128, 256, 512):
        twr, twi = cuda_rx._fft_twiddles(n)
        c, s = dft._dft_mats(n)
        assert np.array_equal(twr, c[1, : n // 2])
        assert np.array_equal(twi, -s[1, : n // 2])
    for n in (1024, 2048, 4096):
        twr, twi = cuda_rx._fft_twiddles(n)
        k = np.arange(n, dtype=np.int64)
        ang = 2.0 * np.pi * ((k[1:2, None] * k[None, :]) % n) / n
        assert twr.shape == (n // 2,)
        assert np.array_equal(twr, np.cos(ang).astype(np.float32)[0, : n // 2])
        assert np.array_equal(twi, -np.sin(ang).astype(np.float32)[0, : n // 2])


# ---------------------------------------------------------------------------
# What lies outside the kernels' domain raises, naming the domain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(sf=12, osr=2),                 # q = 8192: closed form in JAX too
    dict(sf=5, osr=2),                  # q = 64
])
def test_tx_uncovered_config_raises(kw):
    with pytest.raises(terrors.InvalidArgumentError, match="closed form"):
        cuda_tx._require_supported(T.LoraParams(**kw))
    with pytest.raises(terrors.InvalidArgumentError, match="domain"):
        cuda_tx.tx_tone_synth_ref(torch.zeros(1, 4, dtype=torch.int32),
                                  T.LoraParams(**kw))


@pytest.mark.parametrize("kw,wide,halo,match", [
    (dict(sf=7, osr=2), False, (1, 1), "halo"),
    (dict(sf=7, osr=4), False, (0, 1), "halo"),
    (dict(sf=12, bw=500000, osr=8), True, (0, 0), "32768-point"),
    (dict(sf=7, osr=3), True, (0, 0), "384-point"),
    (dict(sf=7), True, (-1, 0), "halo"),
])
def test_rx_uncovered_config_raises(kw, wide, halo, match):
    with pytest.raises(terrors.InvalidArgumentError, match=match):
        cuda_rx._geometry(T.LoraParams(**kw), wide, halo)


def test_supported_predicates():
    """TX: osr 1 from n = 4 to 4096, osr > 1 for tone moduli 128 ... 4096
    (both wide profiles, sf7/osr2); RX: every decimated n = 4 ... 4096 at
    any osr, the wide grid to 16384 points, halos on osr-1 windows."""
    for n in (4, 512, 1024, 2048, 4096):
        assert cuda_tx.tx_supported(n, 1)
    assert not cuda_tx.tx_supported(8192, 1)
    assert cuda_tx.tx_supported(128, 2)
    assert cuda_tx.tx_supported(512, 2, 2) and cuda_tx.tx_supported(4096, 4, 4)
    assert not cuda_tx.tx_supported(4096, 2, 1)       # q = 8192
    assert not cuda_tx.tx_supported(32, 2, 1)         # q = 64
    for sf in range(2, 13):  # n = 4 ... 4096
        for osr in (1, 2, 4):
            p = T.LoraParams(sf=sf, osr=osr)
            assert cuda_rx._geometry(p, False, (0, 0)) == (p.n, osr)
    p = T.LoraParams(sf=12, bw=500000, osr=4)
    assert cuda_rx._geometry(p, True, (1, 1)) == (16384, 1)
    assert cuda_rx._geometry(T.LoraParams(sf=7), False, (1, 0)) == (128, 1)


# ---------------------------------------------------------------------------
# Build (utils/cuda_build.py): nothing at import, sm_90a, errors surface
# ---------------------------------------------------------------------------

def test_kernel_modules_import_without_cuda():
    """The kernel modules import (and build nothing) with no CUDA device."""
    code = (
        f"import {PORT}.ops.cuda_tx, {PORT}.ops.cuda_rx\n"
        f"from {PORT}.utils import cuda_build\n"
        "import torch\n"
        "assert not torch.cuda.is_available()\n"
        "assert cuda_build._lib is None and not cuda_build.BUILD_INFO\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)


def test_nvcc_command_targets_sm90a():
    """One compile per source for sm_90a, then one shared-library link."""
    srcs = sorted(s.name for s in cuda_build._sources()
                  if s.suffix == ".cu")
    assert srcs == ["extract_dechirp.cu", "rotate_detect.cu", "rx_dense.cu",
                    "rx_hybrid.cu", "rx_osr.cu", "stream_scan.cu",
                    "tx_dense.cu", "tx_factored.cu", "tx_osr.cu"]
    cmd = cuda_build.compile_command(Path("csrc/rx_hybrid.cu"),
                                     Path("rx_hybrid.o"))
    assert cmd[:3] == ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a"]
    for flag in ("-std=c++17", "-O3", "-fPIC", "-c", "-Xptxas=-v"):
        assert flag in cmd
    assert cmd[-1] == "csrc/rx_hybrid.cu" and "-shared" not in cmd
    link = cuda_build.link_command([Path("a.o"), Path("b.o")],
                                   Path("lib.so"))
    assert link[:3] == ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a"]
    assert "-shared" in link and link[-2:] == ["a.o", "b.o"]


def test_build_dir_is_content_addressed():
    d = cuda_build.build_dir()
    assert d == cuda_build.build_dir()
    assert d.parent == cuda_build.BUILD_ROOT
    assert cuda_build.BUILD_ROOT.parts[-2:] == ("build", "lora_torch_kernels")


def test_failed_build_raises_with_nvcc_stderr(tmp_path, monkeypatch):
    """A compiler that fails on one source: load() raises with its stderr
    and leaves no library behind."""
    fake_nvcc = [sys.executable, "-c",
                 "import sys; sys.stderr.write('error: no such intrinsic'); "
                 "sys.exit(2)"]
    fine = [sys.executable, "-c", "pass"]
    monkeypatch.setattr(cuda_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(
        cuda_build, "compile_command",
        lambda src, obj, nvcc="nvcc": (fake_nvcc if src.stem == "rx_hybrid"
                                       else fine))
    monkeypatch.setattr(cuda_build, "_lib", None)
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        cuda_build.load()
    assert not list((tmp_path / "build").rglob("*.so"))


def test_missing_nvcc_raises(monkeypatch):
    import torch.utils.cpp_extension as cpp_ext
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build._nvcc()


def test_wrappers_name_the_tpu_kernel_they_replace():
    """Each kernel source and wrapper carries the note of what it replaces
    (file:function), what bounds it on the H100 and what it does about it."""
    root = REPO / PORT
    for src, tpu in (
            ("csrc/tx_dense.cu", "ops/pallas_tx.py:_tx_kernel"),
            ("csrc/tx_factored.cu", "ops/pallas_tx.py:_tx_kernel_factored"),
            ("csrc/rx_dense.cu", "ops/pallas_rx.py:_rx_kernel"),
            ("csrc/rx_hybrid.cu", "ops/pallas_rx.py:_rx_kernel"),
            ("csrc/tx_osr.cu", "ops/pallas_tx.py:_tx_osr_kernel"),
            ("csrc/rx_osr.cu", "ops/pallas_rx.py:_rx_kernel"),
            ("ops/cuda_tx.py", "ops/pallas_tx.py:_tx_kernel_factored"),
            ("ops/cuda_tx.py", "ops/pallas_tx.py:_tx_osr_kernel"),
            ("ops/cuda_rx.py", "ops/pallas_rx.py:_rx_kernel")):
        text = (root / src).read_text()
        assert tpu in text, src
        assert "H100" in text, src
    # each launch path counts its kernel in the one registry
    # (COUNTS["launch.<kernel>"]) and keeps no counter of its own
    for mod, kernels in (("ops/cuda_tx.py", ("tx_dense", "tx_factored",
                                             "tx_osr")),
                         ("ops/cuda_rx.py", ("rx_dense", "rx_hybrid",
                                             "rx_osr")),
                         ("ops/cuda_stream.py", ("stream_scan",)),
                         ("ops/cuda_detect.py", ("rotate_detect",))):
        tree = ast.parse((root / mod).read_text())
        consts = {node.value for node in ast.walk(tree)
                  if isinstance(node, ast.Constant)
                  and isinstance(node.value, str)}
        names = {t.id for node in tree.body if isinstance(node, ast.Assign)
                 for t in node.targets if isinstance(t, ast.Name)}
        counted = {node.func.id for node in ast.walk(tree)
                   if isinstance(node, ast.Call)
                   and isinstance(node.func, ast.Name)}
        assert set(kernels) <= consts | {
            c.rsplit(".", 1)[-1] for c in consts}, mod
        assert "count" in counted and "span" in counted, mod
        assert not {n for n in names if n.endswith("_LAUNCHES")}, mod
