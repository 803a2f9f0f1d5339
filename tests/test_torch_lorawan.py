"""The port's LoRaWAN MAC (``models/lorawan.py``) and host crypto bridge
(``utils/native.py``) against the JAX package's, on the CPU.

The known answers are tests/test_lorawan.py's (FIPS-197 AES, RFC 4493
CMAC, the reference's MIC).  The native AES/CMAC and the pure-Python
fallback are held equal on random keys and messages; frames built by both
packages give the same symbols, and each package parses the other's.
"""
import numpy as np
import pytest

import jax

jax.config.update("jax_platforms", "cpu")

import torch  # noqa: E402

from lora_sdr_lightweight_standalone_library_clean_tpu.models import (  # noqa: E402
    lorawan as jwan)

from lora_sdr_lightweight_standalone_library_clean_tpu_torch.models import (  # noqa: E402
    lorawan as twan)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.models.modem import (  # noqa: E402
    encode as tencode)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.utils import (  # noqa: E402
    native as tnative)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.utils.errors import (  # noqa: E402
    MicMismatchError, RangeError)

torch.set_num_threads(1)

FIPS_KEY = bytes(range(16))
FIPS_PT = bytes.fromhex("00112233445566778899aabbccddeeff")
FIPS_CT = bytes.fromhex("69c4e0d86a7b0430d8cdb78070b4c55a")
RFC_KEY = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
RFC_CASES = [
    (b"", "bb1d6929e95937287fa37d129b756746"),
    (bytes.fromhex("6bc1bee22e409f96e93d7e117393172a"),
     "070a16b46b4d4144f79bdd9dd04a287c"),
    (bytes.fromhex("6bc1bee22e409f96e93d7e117393172aae2d8a571e03ac9c9eb76fac"
                   "45af8e5130c81c46a35ce411"),
     "dfa66747de9ae63030ca32611497c827"),
]
MIC_KEY = bytes([2] * 16)
MIC_MSG = bytes([0x40, 0x04, 0x03, 0x02, 0x01, 0x80, 0x01, 0x00, 0x01,
                 0xA6, 0x94, 0x64, 0x26, 0x15])


def test_aes_fips197_known_answer():
    assert twan.aes128_encrypt_block(FIPS_KEY, FIPS_PT) == FIPS_CT
    assert twan._aes_encrypt_py(FIPS_KEY, FIPS_PT) == FIPS_CT


@pytest.mark.parametrize("msg,mac", RFC_CASES)
def test_cmac_rfc4493_known_answers(msg, mac):
    assert twan._cmac_py(RFC_KEY, msg) == bytes.fromhex(mac)
    if tnative.available():
        assert tnative.cmac(RFC_KEY, msg) == bytes.fromhex(mac)


def test_mic_reference_known_answer():
    """compute_mic == 0x82B5C3D6 (lorawan_mic_test.cpp:10-12), natively and
    through the pure-Python CMAC."""
    assert twan.compute_mic(MIC_KEY, True, 0x01020304, 1, MIC_MSG) \
        == 0x82B5C3D6
    assert twan._mic_py(MIC_KEY, True, 0x01020304, 1, MIC_MSG) == 0x82B5C3D6


def test_native_and_pure_python_crypto_agree():
    """The native AES/CMAC/MIC and the pure-Python fallback give the same
    bytes on random keys and messages of every length class."""
    assert tnative.available(), "native/liblora_host.so did not build"
    rng = np.random.default_rng(0)
    for n in (0, 1, 15, 16, 17, 31, 32, 40, 64):
        key = bytes(rng.integers(0, 256, 16).astype(np.uint8))
        block = bytes(rng.integers(0, 256, 16).astype(np.uint8))
        msg = bytes(rng.integers(0, 256, n).astype(np.uint8))
        assert tnative.aes_ecb_encrypt(key, block) == \
            twan._aes_encrypt_py(key, block)
        assert tnative.cmac(key, msg) == twan._cmac_py(key, msg)
        for uplink in (True, False):
            devaddr = int(rng.integers(0, 2 ** 32))
            fcnt = int(rng.integers(0, 2 ** 16))
            assert tnative.wan_mic(key, uplink, devaddr, fcnt, msg) == \
                twan._mic_py(key, uplink, devaddr, fcnt, msg) == \
                jwan.compute_mic(key, uplink, devaddr, fcnt, msg)


def _frame(mod, rng):
    frame = mod.Frame()
    frame.mhdr.mtype = mod.MType.UNCONFIRMED_DATA_UP
    frame.fhdr.devaddr = 0x01020304
    frame.fhdr.fcnt = int(rng.integers(0, 65536))
    frame.fhdr.fopts = bytes(rng.integers(0, 256, 3).astype(np.uint8))
    frame.payload = bytes(rng.integers(0, 256, 8).astype(np.uint8))
    return frame


def test_frame_roundtrip_and_parity_with_jax():
    """build_frame -> parse_frame (lorawan_roundtrip.cpp:29-72) on the CPU:
    the port's symbols equal the JAX package's, and each package parses the
    other's."""
    key = bytes(range(16))
    for seed in range(5):
        tframe = _frame(twan, np.random.default_rng(seed))
        jframe = _frame(jwan, np.random.default_rng(seed))
        assert twan.serialize_frame(key, tframe) == \
            jwan.serialize_frame(key, jframe)
        tsyms = twan.build_frame(key, tframe, device="cpu")
        jsyms = np.asarray(jwan.build_frame(key, jframe))
        assert tsyms.device.type == "cpu"
        np.testing.assert_array_equal(tsyms.numpy(), jsyms)
        for out in (twan.parse_frame(key, tsyms),
                    jwan.parse_frame(key, tsyms.numpy())):
            assert out.payload == tframe.payload
            assert out.fhdr.devaddr == tframe.fhdr.devaddr
            assert out.fhdr.fcnt == tframe.fhdr.fcnt
            assert out.fhdr.fopts == tframe.fhdr.fopts
            assert out.mhdr.mtype == tframe.mhdr.mtype
        assert twan.parse_frame(key, torch.as_tensor(jsyms)).payload == \
            tframe.payload


def test_symbol_flips_corrected_and_mismatched_like_jax():
    """A single-bit flip is repaired by Hamming(8,4); an uncorrectable
    2-bit flip raises MicMismatchError (lorawan.cpp:159-161)."""
    key = bytes(16)
    frame = twan.Frame()
    frame.payload = b"\xaa"
    syms = twan.build_frame(key, frame, device="cpu").clone()
    one = syms.clone()
    one[0] ^= 1
    assert twan.parse_frame(key, one).payload == frame.payload
    two = syms.clone()
    two[0] ^= 0x03
    with pytest.raises(MicMismatchError):
        twan.parse_frame(key, two)
    with pytest.raises(jwan.MicMismatchError):
        jwan.parse_frame(key, two.numpy())


def test_error_paths():
    """Too short, FOpts overrun (lorawan.cpp:172) and the FOpts cap raise
    RangeError, as in the JAX package."""
    key = bytes(16)
    with pytest.raises(RangeError):
        twan.parse_frame(key, torch.zeros(4, dtype=torch.int32))
    body = bytes([0, 0, 0, 0, 0, 0x05, 0, 0])
    wire = body + twan.compute_mic(key, True, 0, 0, body).to_bytes(4, "little")
    syms = tencode(torch.as_tensor(np.frombuffer(wire, np.uint8).copy())[None])
    with pytest.raises(RangeError):
        twan.parse_frame(key, syms[0])
    frame = twan.Frame()
    frame.fhdr.fopts = bytes(16)
    with pytest.raises(RangeError):
        twan.build_frame(key, frame, device="cpu")
    with pytest.raises(RangeError):
        twan.build_frame(key, twan.Frame(), symbol_cap=4, device="cpu")
