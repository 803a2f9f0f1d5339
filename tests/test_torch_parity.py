"""The port's slice end to end against the JAX package, against the
C-reference fixtures, and the rule that the port never imports jax.

Slice: ``encode -> modulate_dechirped -> demodulate_tones -> decode`` on the
same numpy payloads (CRC-valid and corrupted) in both packages, on the CPU.
Symbols, sync word, decoded bytes and ``crc_ok`` must be exact; CFO within
1e-5, timing within 1e-3 samples, dB within 0.05 (summation order of the
float32 DFTs).
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

import lora_sdr_lightweight_standalone_library_clean_tpu_torch as T  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT = "lora_sdr_lightweight_standalone_library_clean_tpu_torch"
VEC_DIR = Path(__file__).parent / "vectors"
FIXTURES = sorted(f for f in VEC_DIR.glob("ref_*.npz")
                  if not f.stem.startswith("ref_offsets"))


def _payloads(sf, packets=6, nbytes=12):
    """Payloads whose last two bytes are the SX1272 CRC of bytes 2..k-3;
    every third packet then has one data byte changed."""
    rng = np.random.default_rng(100 + sf)
    pay = rng.integers(0, 256, (packets, nbytes)).astype(np.uint8)
    crc = np.asarray(J.crc_sx1272(pay[:, 2:nbytes - 2])).astype(np.int64)
    pay[:, nbytes - 2] = crc & 0xFF
    pay[:, nbytes - 1] = crc >> 8
    pay[::3, 4] ^= 0x5A
    return pay


@pytest.mark.parametrize("sf", [7, 8, 9])
def test_slice_matches_jax(sf):
    pay = _payloads(sf)
    jp = J.LoraParams(sf=sf)
    tp = T.params_from_reference(jp)

    jdr, jdi = J.modulate_dechirped(J.encode(pay), jp)
    jres = J.demodulate_tones(jdr, jdi, jp)
    jdec, jok = J.decode(jres.symbols)

    tdr, tdi = T.modulate_dechirped(T.encode(torch.as_tensor(pay)), tp)
    tres = T.demodulate_tones(tdr, tdi, tp)
    tdec, tok = T.decode(tres.symbols)

    np.testing.assert_allclose(tdr.numpy(), np.asarray(jdr), atol=4e-6,
                               rtol=0)
    np.testing.assert_array_equal(tres.symbols.numpy(),
                                  np.asarray(jres.symbols))
    np.testing.assert_array_equal(tres.sync_word.numpy(),
                                  np.asarray(jres.sync_word))
    assert (tres.sync_word.numpy() == 0x12).all()
    np.testing.assert_array_equal(tdec.numpy(), np.asarray(jdec))
    np.testing.assert_array_equal(tdec.numpy(), pay)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert tok.numpy().tolist() == [i % 3 != 0 for i in range(len(pay))]
    np.testing.assert_allclose(tres.cfo.numpy(), np.asarray(jres.cfo),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(tres.time_offset.numpy(),
                               np.asarray(jres.time_offset), atol=1e-3,
                               rtol=0)
    for f in ("power", "power_avg"):
        np.testing.assert_allclose(getattr(tres, f).numpy(),
                                   np.asarray(getattr(jres, f)), atol=0.05,
                                   rtol=0)


@pytest.mark.parametrize("window", ["none", "hann"])
def test_demodulate_tones_noisy_matches_jax(window):
    """Noisy, scaled-up (normalised) packets: symbols exact, estimates and
    dB within the slice tolerances."""
    jp = J.LoraParams(sf=7, window=window)
    tp = T.params_from_reference(jp)
    rng = np.random.default_rng(9)
    pay = rng.integers(0, 256, (6, 12)).astype(np.uint8)
    dr, di = J.dechirp(*J.modulate(J.encode(pay), jp), jp)
    dr = (np.asarray(dr) + rng.standard_normal(dr.shape) * 0.1) * 3.0
    di = (np.asarray(di) + rng.standard_normal(di.shape) * 0.1) * 3.0
    dr, di = dr.astype(np.float32), di.astype(np.float32)
    jres = J.demodulate_tones(jnp.asarray(dr), jnp.asarray(di), jp)
    tres = T.demodulate_tones(torch.as_tensor(dr), torch.as_tensor(di), tp)
    np.testing.assert_array_equal(tres.symbols.numpy(),
                                  np.asarray(jres.symbols))
    np.testing.assert_array_equal(tres.sync_word.numpy(),
                                  np.asarray(jres.sync_word))
    np.testing.assert_allclose(tres.cfo.numpy(), np.asarray(jres.cfo),
                               atol=1e-5)
    np.testing.assert_allclose(tres.time_offset.numpy(),
                               np.asarray(jres.time_offset), atol=1e-3)
    np.testing.assert_allclose(tres.power.numpy(), np.asarray(jres.power),
                               atol=0.05)


def test_demodulate_tones_without_sync_symbols():
    """One symbol: no sync word, every detection is data (LoRaDemod.cpp:
    166-193)."""
    jp = J.LoraParams(sf=7)
    tp = T.LoraParams(sf=7)
    rng = np.random.default_rng(4)
    z = rng.standard_normal((2, 2, jp.n)).astype(np.float32)
    jres = J.demodulate_tones(jnp.asarray(z[0]), jnp.asarray(z[1]), jp)
    tres = T.demodulate_tones(torch.as_tensor(z[0]), torch.as_tensor(z[1]),
                              tp)
    np.testing.assert_array_equal(tres.symbols.numpy(),
                                  np.asarray(jres.symbols))
    assert tres.symbols.shape == (2, 1)
    assert (tres.sync_word.numpy() == 0).all()


@pytest.mark.parametrize("sf,bw", [(7, 125000), (9, 250000), (11, 500000),
                                   (12, 125000)])
def test_modulate_dechirped_matches_jax(sf, bw):
    """The plain TX kernel version with the folded down-chirp (dense
    tables to sf9, factored digit tables at sf11/12) against JAX's
    modulate then dechirp: within 4e-6 (tests/test_pallas.py:299)."""
    jp = J.LoraParams(sf=sf, bw=bw)
    tp = T.params_from_reference(jp)
    syms = np.random.default_rng(sf).integers(0, 1 << sf, (4, 12)).astype(
        np.uint16)
    tsyms = torch.as_tensor(syms.astype(np.int32))
    wr, wi = J.modulate_dechirped(syms, jp)
    gr, gi = T.modulate_dechirped(tsyms, tp)
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), atol=4e-6, rtol=0)
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), atol=4e-6, rtol=0)
    mr, mi = T.modulate(tsyms, tp)
    jr, ji = J.modulate(syms, jp)
    np.testing.assert_allclose(mr.numpy(), np.asarray(jr), atol=2e-6, rtol=0)
    np.testing.assert_allclose(mi.numpy(), np.asarray(ji), atol=2e-6, rtol=0)


def test_modulate_dechirped_outside_the_kernel_on_cpu():
    """sf5/osr2 (tone modulus 64, below the TX kernels' 128) on the CPU:
    modulate then dechirp, as the JAX package does off its TX kernel;
    within 4e-6."""
    jp = J.LoraParams(sf=5, osr=2)
    tp = T.params_from_reference(jp)
    syms = np.random.default_rng(5).integers(0, 64, (2, 6)).astype(np.uint16)
    wr, wi = J.modulate_dechirped(syms, jp)
    gr, gi = T.modulate_dechirped(torch.as_tensor(syms.astype(np.int32)), tp)
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), atol=4e-6, rtol=0)
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), atol=4e-6, rtol=0)


# ---------------------------------------------------------------------------
# C-reference fixtures (tests/test_parity.py:43-78), osr 1 and 2
# ---------------------------------------------------------------------------

def _fixture_params(d):
    return T.LoraParams(sf=int(d["sf"]), bw=int(d["bw"]), osr=int(d["osr"]),
                        window=str(d["window"]))


@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: p.stem)
def test_tones_path_bins(path):
    """Dechirped detection recovers (sym * bw_scale) mod N for every encoded
    symbol of the reference's IQ, and the sync nibbles likewise."""
    d = np.load(path)
    p = _fixture_params(d)
    nsym = d["iq"].size // p.step - 2
    enc = d["encoded"][:nsym].astype(np.int64)
    rr, ri = T.from_complex(d["iq"][None], device="cpu")
    dr, di = T.dechirp(rr, ri, p)
    res = T.demodulate_tones(dr, di, p)
    np.testing.assert_array_equal(res.symbols.numpy()[0],
                                  (enc * p.bw_scale) % p.n)
    sw0, sw1 = p.sync_nibble_symbols()
    shift = p.sf - 4 if p.sf > 4 else 0
    exp_sync = ((((sw0 * p.bw_scale) % p.n) >> shift & 0xF) << 4) | \
        (((sw1 * p.bw_scale) % p.n) >> shift & 0xF)
    assert int(res.sync_word[0]) == exp_sync


@pytest.mark.parametrize(
    "path", [f for f in FIXTURES if int(np.load(f)["bw"]) == 125000],
    ids=lambda p: p.stem)
def test_payload_roundtrip_from_reference_iq(path):
    """The payload decodes bit-exactly from the reference's IQ through the
    tones path (bw_scale == 1; Hamming corrects the clipped codeword MSB)."""
    d = np.load(path)
    p = _fixture_params(d)
    rr, ri = T.from_complex(d["iq"][None], device="cpu")
    dr, di = T.dechirp(rr, ri, p)
    res = T.demodulate_tones(dr, di, p)
    dec, _ = T.decode(res.symbols)
    np.testing.assert_array_equal(dec.numpy()[0], d["payload"])


# ---------------------------------------------------------------------------
# Full RX (demodulate) and the offset probe against the reference and JAX
# (tests/test_parity.py:30-41,141-159)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: p.stem)
def test_full_path_demod_bit_exact(path):
    """``demodulate`` on the reference's IQ reproduces the reference's own
    demod output (osr 2 and Hann included, on the CPU plain path), and
    JAX's ``demodulate``: symbols and sync exact, CFO within 1e-5, timing
    within 1e-3 samples, dB within 0.05."""
    d = np.load(path)
    p = _fixture_params(d)
    jp = J.LoraParams(sf=p.sf, bw=p.bw, osr=p.osr, window=p.window.value)
    rr, ri = T.from_complex(d["iq"][None], device="cpu")
    res = T.demodulate(rr, ri, p)
    mine = res.symbols.numpy()[0]
    np.testing.assert_array_equal(mine, d["demod"][: len(mine)])
    jres = J.demodulate(*J.from_complex(d["iq"][None]), jp)
    np.testing.assert_array_equal(res.symbols.numpy(),
                                  np.asarray(jres.symbols))
    np.testing.assert_array_equal(res.sync_word.numpy(),
                                  np.asarray(jres.sync_word))
    np.testing.assert_allclose(res.cfo.numpy(), np.asarray(jres.cfo),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(res.time_offset.numpy(),
                               np.asarray(jres.time_offset), atol=1e-3,
                               rtol=0)
    for f in ("power", "power_avg"):
        np.testing.assert_allclose(getattr(res, f).numpy(),
                                   np.asarray(getattr(jres, f)), atol=0.05,
                                   rtol=0)


OFFSET_FIXTURES = sorted(VEC_DIR.glob("ref_offsets_*.npz"))


@pytest.mark.parametrize("path", OFFSET_FIXTURES, ids=lambda p: p.stem)
def test_estimate_and_compensate_offsets_parity(path):
    """estimate_offsets + compensate_offsets against the reference probe on
    the same impaired IQ (phy.cpp:81-180), with the tolerances of
    tests/test_parity.py:141-159."""
    d = np.load(path)
    p = T.LoraParams(sf=int(d["sf"]))
    rr, ri = T.from_complex(d["iq"], device="cpu")
    est = T.estimate_offsets(rr, ri, p)
    assert abs(float(est.cfo) - float(d["ref_cfo"])) < 2e-5
    assert abs(float(est.time_offset) - float(d["ref_time_offset"])) < 1e-3
    cr, ci = T.compensate_offsets(rr, ri, p, est)
    want = d["compensated"]
    np.testing.assert_allclose(cr.numpy(), want.real, atol=2e-4)
    np.testing.assert_allclose(ci.numpy(), want.imag, atol=2e-4)


# ---------------------------------------------------------------------------
# The port never imports jax
# ---------------------------------------------------------------------------

def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_port_sources_import_no_jax():
    files = sorted((REPO / PORT).rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tools" / "profile_slice.py"]
    assert len(files) >= 14
    for f in files:
        for name in _imports(ast.parse(f.read_text())):
            root = name.split(".")[0]
            assert root != "jax" and root != "jaxlib", (f, name)
            assert not name.startswith(
                "lora_sdr_lightweight_standalone_library_clean_tpu") or \
                name.startswith(PORT), (f, name)


def test_port_import_loads_no_jax_module():
    code = (f"import sys, {PORT}\n"
            f"import {PORT}.ops.cuda_tx, {PORT}.ops.cuda_rx\n"
            f"import {PORT}.ops.cuda_stream, {PORT}.ops.cuda_detect\n"
            f"import {PORT}.parallel.streaming, {PORT}.parallel.receiver\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib') or m.startswith('"
            "lora_sdr_lightweight_standalone_library_clean_tpu.')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   env=dict(os.environ), timeout=120)


def test_public_names():
    for name in ("LoraParams", "Window", "load_profiles",
                 "params_from_profile", "params_from_reference",
                 "STOCK_PROFILES", "errors", "encode", "decode", "modulate",
                 "modulate_dechirped", "estimate_offsets", "dechirp",
                 "to_complex", "from_complex", "crc_sx1272", "DemodResult",
                 "OffsetEstimate", "demodulate_tones", "demodulate",
                 "compensate_offsets", "demodulate_wide", "streaming",
                 "receive_stream", "stream_rx_init", "packet_samples",
                 "StreamRxState", "RecoveredPackets"):
        assert hasattr(T, name), name
        assert name == "params_from_reference" or hasattr(J, name), name
