"""ctypes bridge to the repo's native host library (native/liblora_host.so).

PyTorch port of ``lora_sdr_lightweight_standalone_library_clean_tpu/utils/
native.py``, at the same relative path.  The card owns the DSP path; the
native library owns host work mirroring the reference's C components:
AES-128/CMAC for the LoRaWAN MIC.  It is built with ``make`` on first use;
each function returns ``None`` when the library cannot be built or loaded,
and its caller (``models/lorawan.py``) then takes the pure-Python AES/CMAC
the JAX package also keeps.  ``native/`` is shared with the JAX package and
not modified here.
"""
from __future__ import annotations

import ctypes
import functools
import subprocess
from pathlib import Path

_NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "liblora_host.so"


@functools.lru_cache(maxsize=None)
def load():
    """Load (building if necessary) the native library, or return None."""
    try:
        if not _LIB_PATH.exists():
            subprocess.run(["make", "-s"], cwd=_NATIVE_DIR, check=True,
                           capture_output=True, timeout=120)
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.lora_wan_mic.restype = ctypes.c_uint32
        lib.lora_wan_mic.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64]
        lib.lora_aes128_ecb_encrypt.restype = None
        lib.lora_aes128_ecb_encrypt.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8)]
        lib.lora_cmac.restype = None
        lib.lora_cmac.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint8)]
    except (OSError, subprocess.SubprocessError, AttributeError):
        return None
    return lib


def available() -> bool:
    """Whether the native AES/CMAC is in use (else the pure-Python one)."""
    return load() is not None


def aes_ecb_encrypt(key: bytes, block: bytes) -> bytes | None:
    lib = load()
    if lib is None:
        return None
    buf = (ctypes.c_uint8 * 16)(*block)
    lib.lora_aes128_ecb_encrypt((ctypes.c_uint8 * 16)(*key), buf)
    return bytes(buf)


def cmac(key: bytes, msg: bytes) -> bytes | None:
    lib = load()
    if lib is None:
        return None
    mac = (ctypes.c_uint8 * 16)()
    lib.lora_cmac((ctypes.c_uint8 * 16)(*key),
                  (ctypes.c_uint8 * max(len(msg), 1))(*msg), len(msg), mac)
    return bytes(mac)


def wan_mic(key: bytes, uplink: bool, devaddr: int, fcnt: int,
            msg: bytes) -> int | None:
    lib = load()
    if lib is None:
        return None
    return int(lib.lora_wan_mic(
        (ctypes.c_uint8 * 16)(*key), int(uplink), devaddr & 0xFFFFFFFF,
        fcnt & 0xFFFFFFFF,
        (ctypes.c_uint8 * max(len(msg), 1))(*msg), len(msg)))
