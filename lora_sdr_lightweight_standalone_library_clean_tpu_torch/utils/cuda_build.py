"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Counterpart of the JAX package's ``utils/native.py``, which builds the host
library lazily.  On first use, ``load()`` compiles every ``csrc/*.cu``
source with ``nvcc`` for Hopper (``sm_90a``), one process per source, all
started together::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -Xptxas=-v -c -o <source>.o csrc/<source>.cu

links the objects into one shared library with a plain C interface
(``nvcc -shared -o libkernels.so *.o``) and loads it with ``ctypes``.  The
library lands in ``build/lora_torch_kernels/<content-hash>/libkernels.so``
at the root of the checkout, keyed by the sources and flags, so an edited
kernel is rebuilt and an unchanged one is loaded as it is.  Nothing builds
at import time: the CPU tests import every module on machines with no CUDA
toolkit.  A failed build raises with nvcc's stderr; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["load", "compile_command", "link_command", "build_dir",
           "BUILD_INFO"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = (Path(__file__).resolve().parent.parent.parent / "build"
              / "lora_torch_kernels")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas=-v")
BUILD_TIMEOUT = 600       # seconds for the compiles, and again for the link

_c_int = ctypes.c_int
_c_float = ctypes.c_float
_c_void_p = ctypes.c_void_p

# C signatures of the kernels' launch functions (each returns the
# cudaError_t of cudaGetLastError() after its launch).
# sr, si, t_off, rate, scale, mr, mi, tw, bins, b, s, n, scale_db,
# idx, pw, pav, stream
_RX_SIGNATURE = [_c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
                 _c_void_p, _c_void_p, _c_void_p, _c_void_p,
                 _c_int, _c_int, _c_int, _c_float,
                 _c_void_p, _c_void_p, _c_void_p, _c_void_p]
_SIGNATURES = {
    # sym, rows, s_total, n, bs, alt_sign, wc, ws, out_re, out_im, stream
    "lora_tx_dense": [_c_void_p, _c_int, _c_int, _c_int, _c_int, _c_int,
                      _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p],
    # sym, rows, s_total, n, bs, alt_sign, w1c, w1s, w2c, w2s, mr, mi,
    # out_re, out_im, stream
    "lora_tx_factored": [_c_void_p, _c_int, _c_int, _c_int, _c_int, _c_int,
                         _c_void_p, _c_void_p, _c_void_p, _c_void_p,
                         _c_void_p, _c_void_p, _c_void_p, _c_void_p,
                         _c_void_p],
    # sym, rows, s_total, q, bs, osr, period, gated, tab_c, tab_s, w2c, w2s,
    # wtc, wts, mr, mi, out_re, out_im, stream
    "lora_tx_osr": [_c_void_p] + [_c_int] * 7 + [_c_void_p] * 11,
    "lora_rx_dense": _RX_SIGNATURE,
    "lora_rx_hybrid": _RX_SIGNATURE,
    # sr, si, t_off, rate, scale, mr, mi, tw, bins, b, s, n, osr, h0, h1,
    # scale_db, idx, pw, pav, stream
    "lora_rx_osr": [_c_void_p] * 9 + [_c_int] * 6 + [_c_float]
                   + [_c_void_p] * 4,
    # sr, si, mr, mi, tw, bins, b, len (64-bit), w, stride, n, osr,
    # scale_db, idx, pw, pav, stream
    "lora_stream_scan": [_c_void_p] * 6 + [_c_int, ctypes.c_longlong]
                        + [_c_int] * 4 + [_c_float] + [_c_void_p] * 4,
    # zr, zi, rate, start, tw, bins, b, s, n, scale_db, idx, pw, pav, stream
    "lora_rotate_detect": [_c_void_p] * 6 + [_c_int] * 3 + [_c_float]
                          + [_c_void_p] * 4,
    # sr, si, len (64-bit), pos, k, plen, cr, ci, step, out_r, out_i, stream
    "lora_extract_dechirp": [_c_void_p, _c_void_p, ctypes.c_longlong,
                             _c_void_p, _c_int, _c_int, _c_void_p, _c_void_p,
                             _c_int, _c_void_p, _c_void_p, _c_void_p],
    # sym, k, s, sf, rdd, max_len, crc, body_cw, dec84, err84, decp, errp,
    # keys, crc_tab, vseq, vseq_len, payload, length, hdr_ok, crc_ok, n_err,
    # stream
    "lora_decode_frame": [_c_void_p] + [_c_int] * 7 + [_c_void_p] * 7
                         + [_c_int] + [_c_void_p] * 6,
}

# Filled by load(): library path, build seconds (0.0 when it was cached)
# and nvcc's stderr (the -Xptxas=-v register/shared-memory report).
BUILD_INFO: dict = {}
_lib = None


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def build_dir() -> Path:
    """The content-addressed build directory of the current sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    # torch's own lookup: CUDA_HOME / CUDA_PATH or the toolkit's default
    # install prefix
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and Path(CUDA_HOME, "bin", "nvcc").exists():
        return str(Path(CUDA_HOME, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or CUDA_HOME set)")


def compile_command(src: Path, obj: Path, nvcc: str = "nvcc") -> list[str]:
    """The nvcc command line that compiles one source into ``obj``."""
    return [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]


def link_command(objs, out: Path, nvcc: str = "nvcc") -> list[str]:
    """The nvcc command line that links ``objs`` into the library ``out``."""
    return [nvcc, *ARCH_FLAGS, "-shared", "-o", str(out),
            *(str(o) for o in objs)]


def _run_all(commands) -> list[str]:
    """Run the commands side by side; return their stderr in order, or
    raise with the stderr of every one that failed.  No process outlives
    the call."""
    procs = []
    try:
        for cmd in commands:
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
        results = [p.communicate(timeout=BUILD_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"nvcc failed (exit {p.returncode}) on {cmd[-1]}:\n{err}"
              for cmd, p, (_, err) in zip(commands, procs, results)
              if p.returncode != 0]
    if failed:
        raise RuntimeError("\n".join(failed))
    return [err for _, err in results]


def _build(target: Path) -> str:
    target.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # build beside the target, then rename: a concurrent loader never
    # sees a half-written library
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        srcs = [s for s in _sources() if s.suffix == ".cu"]
        objs = [Path(tmp, s.stem + ".o") for s in srcs]
        logs = _run_all([compile_command(s, o, nvcc)
                         for s, o in zip(srcs, objs)])
        lib = Path(tmp, target.name)
        _run_all([link_command(objs, lib, nvcc)])
        os.replace(lib, target)
    return "".join(logs)


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises on failure."""
    global _lib
    if _lib is not None:
        return _lib
    target = build_dir() / "libkernels.so"
    t0 = time.perf_counter()
    log = ""
    if not target.exists():
        log = _build(target)
    seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(target))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    BUILD_INFO.update(path=str(target), seconds=seconds, log=log)
    _lib = lib
    return lib
