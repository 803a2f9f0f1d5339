"""The port's command-line runners (``runners/``) against the JAX
package's, on the CPU.

Both packages' ``main(argv)`` run in this process on the same files, the
port's with ``--device cpu``; their standard output must be identical (the
IQ files the two ``tx`` write agree within 1e-6).  The sweep's noise is
drawn by each package's own generator, so ``awgn_sweep`` is compared at
SNRs where every packet is decided: all lost at -30 dB, all received at
10 dB.  One subprocess drive of the port's ``tx | rx`` shows that no jax
module gets loaded.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax

jax.config.update("jax_platforms", "cpu")

import torch  # noqa: E402

import lora_sdr_lightweight_standalone_library_clean_tpu as J  # noqa: E402
from lora_sdr_lightweight_standalone_library_clean_tpu.models import (  # noqa: E402
    frame as jframe)
from lora_sdr_lightweight_standalone_library_clean_tpu.runners import (  # noqa: E402
    awgn_sweep as j_sweep, lorawan_roundtrip as j_wan, rx as j_rx,
    stream_rx as j_stream, tx as j_tx)

from lora_sdr_lightweight_standalone_library_clean_tpu_torch.runners import (  # noqa: E402
    awgn_sweep as t_sweep, lorawan_roundtrip as t_wan, rx as t_rx,
    stream_rx as t_stream, tx as t_tx)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT = "lora_sdr_lightweight_standalone_library_clean_tpu_torch"
CPU = ["--device", "cpu"]


def _run(capsys, jmain, tmain, argv):
    """Both mains on ``argv`` (the port's on the CPU): (rc, stdout,
    stderr) of each."""
    rc_j = jmain(list(argv))
    j = capsys.readouterr()
    rc_t = tmain(list(argv) + CPU)
    t = capsys.readouterr()
    return (rc_j, j.out, j.err), (rc_t, t.out, t.err)


def _same_stdout(capsys, jmain, tmain, argv):
    (rc_j, jout, jerr), (rc_t, tout, terr) = _run(capsys, jmain, tmain, argv)
    assert rc_j == rc_t == 0, (jerr, terr)
    assert tout == jout
    return tout, jerr, terr


@pytest.mark.parametrize("argv", [
    ["--payload=DEADBEEFCAFEF00D", "--sf=7"],
    ["--payload=0011AA", "--sf=8", "--cr=4/6", "--framed"],
    ["--payload=C0FFEE", "--sf=9", "--bw=250000", "--osr=2", "--framed",
     "--no-crc"],
    ["--payload=0102030405", "--sf=12", "--amplitude=0.5"],
])
def test_tx_writes_the_same_iq(tmp_path, capsys, argv):
    jout, tout = tmp_path / "j.f32", tmp_path / "t.f32"
    assert j_tx.main(argv + [f"--out={jout}"]) == 0
    jerr = capsys.readouterr().err
    assert t_tx.main(argv + [f"--out={tout}"] + CPU) == 0
    terr = capsys.readouterr().err
    assert terr.replace(str(tout), "X") == jerr.replace(str(jout), "X")
    a, b = np.fromfile(jout, np.float32), np.fromfile(tout, np.float32)
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, atol=1e-6, rtol=0)


@pytest.mark.parametrize("tx_argv,rx_argv,payload", [
    (["--sf=7"], ["--sf=7", "--report-offsets"], "DEADBEEFCAFEF00D"),
    (["--sf=8", "--cr=4/6", "--framed"],
     ["--sf=8", "--cr=4/6", "--framed", "--report-offsets"],
     "DEADBEEFCAFE01"),
    (["--sf=9", "--bw=250000", "--osr=2"],
     ["--sf=9", "--bw=250000", "--osr=2", "--path=wide"], "0011AA22"),
    (["--sf=7"], ["--sf=7", "--path=full"], "A5A5"),
])
def test_rx_prints_the_same(tmp_path, capsys, tx_argv, rx_argv, payload):
    iq = tmp_path / "iq.f32"
    assert j_tx.main([f"--payload={payload}", f"--out={iq}"] + tx_argv) == 0
    capsys.readouterr()
    out, jerr, terr = _same_stdout(capsys, j_rx.main, t_rx.main,
                                   [f"--in={iq}"] + rx_argv)
    if "--path=full" not in rx_argv:
        assert out.strip() == payload
    if "--framed" in rx_argv:
        assert "crc_ok=True" in terr and "crc_ok=True" in jerr
    if "--report-offsets" in rx_argv:
        assert "sync=0x12" in terr


def _capture(tmp_path, sr, si):
    inter = np.empty(2 * sr.size, np.float32)
    inter[0::2], inter[1::2] = sr, si
    cap = tmp_path / "capture.f32"
    inter.tofile(cap)
    return cap


def _with_crc(body):
    crc = int(np.asarray(J.crc_sx1272(np.asarray(body[2:]))))
    return np.concatenate([body, [crc & 0xFF, crc >> 8]]).astype(np.uint8)


@pytest.mark.parametrize("kw,extra,offsets,n_samp", [
    (dict(sf=7), ["--sf=7", "--payload-bytes=8", "--chunk=16384"],
     (1000, 40007), 60000),
    (dict(sf=9, bw=250000, osr=2),
     ["--sf=9", "--bw=250000", "--osr=2", "--payload-bytes=8",
      "--chunk=32768"], (997, 30011), 65536),
])
def test_stream_rx_prints_the_same(tmp_path, capsys, kw, extra, offsets,
                                   n_samp):
    """tests/test_runners.py's stream_rx captures, plain and wide."""
    p = J.LoraParams(**kw)
    rng = np.random.default_rng(1)
    sr = rng.standard_normal(n_samp).astype(np.float32) * 0.03
    si = rng.standard_normal(n_samp).astype(np.float32) * 0.03
    payloads = []
    for g in offsets:
        pl = _with_crc(rng.integers(0, 256, 6).astype(np.uint8))
        payloads.append(pl)
        re, im = J.modulate(J.encode(pl[None]), p)
        sr[g:g + re.shape[-1]] += np.asarray(re)[0]
        si[g:g + re.shape[-1]] += np.asarray(im)[0]
    cap = _capture(tmp_path, sr, si)
    out, _, _ = _same_stdout(capsys, j_stream.main, t_stream.main,
                             [f"--in={cap}"] + extra)
    want = [f"{g} 1 {bytes(pl).hex().upper()}"
            for g, pl in zip(offsets, payloads)]
    assert out.splitlines() == want


def test_framed_stream_rx_prints_the_same(tmp_path, capsys):
    """Mixed-length frames (tests/test_runners.py's framed capture)."""
    p = J.LoraParams(sf=7, cr="4/8")
    rng = np.random.default_rng(0)
    sr = (rng.standard_normal(32768) * 0.05).astype(np.float32)
    si = (rng.standard_normal(32768) * 0.05).astype(np.float32)
    pays = [rng.integers(0, 256, 5, dtype=np.uint8),
            rng.integers(0, 256, 12, dtype=np.uint8)]
    for g, pay in zip((3008, 12000), pays):
        re, im = J.modulate(np.asarray(jframe.encode_frame(pay, p))[None], p)
        n = np.asarray(re).shape[-1]
        sr[g:g + n] += np.asarray(re)[0]
        si[g:g + n] += np.asarray(im)[0]
    cap = _capture(tmp_path, sr, si)
    out, _, _ = _same_stdout(
        capsys, j_stream.main, t_stream.main,
        [f"--in={cap}", "--sf=7", "--cr=4/8", "--payload-bytes=16",
         "--framed"])
    lines = [line.split() for line in out.splitlines()]
    assert [ln[2] for ln in lines] == [bytes(x).hex().upper() for x in pays]
    assert [ln[3] for ln in lines] == ["len=5", "len=12"]


def test_lorawan_roundtrip_prints_the_same(capsys):
    for payload in ("0011223344556677", "A0"):
        _, jerr, terr = _same_stdout(capsys, j_wan.main, t_wan.main,
                                     [f"--payload={payload}"])
        assert terr == jerr and "OK" in terr


def test_awgn_sweep_prints_the_same_where_every_packet_is_decided(capsys):
    """At 10 dB every packet is received in both packages, so the CSVs are
    identical, theory column included; at -30 dB every packet is lost in
    both (PER 1, no CRC passes)."""
    _same_stdout(capsys, j_sweep.main, t_sweep.main,
                 ["--sf=7", "--snr-start=10", "--snr-stop=10",
                  "--packets=32", "--bytes=4", "--theory"])
    (_, jout, _), (_, tout, _) = _run(
        capsys, j_sweep.main, t_sweep.main,
        ["--sf=7", "--snr-start=-30", "--snr-stop=-30", "--packets=32",
         "--bytes=4"])
    assert tout.splitlines()[0] == jout.splitlines()[0]
    for row in (jout, tout):
        snr, _, _, per, crc = row.splitlines()[1].split(",")
        assert (snr, per, crc) == ("-30", "1", "0")
    (rc_j, _, jerr), (rc_t, _, terr) = _run(
        capsys, j_sweep.main, t_sweep.main, ["--snr-step=0"])
    assert rc_j == rc_t == 1 and terr == jerr


def test_tx_pipe_rx_in_a_subprocess_loads_no_jax(tmp_path):
    """The port's tx | rx as one would run them from a shell (stdout to
    stdin), on the CPU; neither process loads a jax module."""
    check = ("import runpy, sys\n"
             "try:\n"
             "    runpy.run_module(sys.argv.pop(1), run_name='__main__')\n"
             "finally:\n"
             "    bad = [m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib')]\n"
             "    assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))

    def cmd(mod, *args):
        return [sys.executable, "-c", check, f"{PORT}.runners.{mod}", *args]

    tx = subprocess.run(cmd("tx", "--payload=0011AA", "--sf=8", "--out=-",
                            "--device", "cpu"),
                        capture_output=True, cwd=REPO, env=env, timeout=240)
    assert tx.returncode == 0, tx.stderr.decode()
    rx = subprocess.run(cmd("rx", "--in=-", "--sf=8", "--device", "cpu"),
                        input=tx.stdout, capture_output=True, cwd=REPO,
                        env=env, timeout=240)
    assert rx.returncode == 0, rx.stderr.decode()
    assert rx.stdout.decode().strip() == "0011AA"
