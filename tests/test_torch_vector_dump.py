"""The port's ``runners/vector_dump.py`` and ``utils/vectors.py`` against
the JAX package's, on the CPU.

Both ``main``s run in-process with the same flags (the port's with
``--device cpu``) into their own directories.  Every integer stage file
(``payload.bin``, ``pre_interleave.csv``, ``post_interleave.csv``,
``demod_symbols.csv``, ``deinterleave.csv``, ``decoded.bin``; framed:
``frame_symbols.csv``, ``frame_meta.csv``) must be identical, and
``iq_samples.csv`` within 1e-5 (float32 chirp synthesis in two
frameworks; both print ``%g``).  With ``--snr-db`` the noise differs by
design (a ``torch.Generator`` where JAX takes ``PRNGKey(seed)``), so only
the port's decode is checked.  The golden blobs of the reference are not
in the repository, so the readers are held to each other on synthetic
blobs of every format, written here with ``struct``.  jax is imported
inside the tests.
"""
import base64
import struct

import numpy as np
import pytest

from lora_sdr_lightweight_standalone_library_clean_tpu_torch.runners import (
    vector_dump as tvd)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.utils import (
    vectors as tvec)

INTEGER_STAGES = ("payload.bin", "pre_interleave.csv", "post_interleave.csv",
                  "demod_symbols.csv", "deinterleave.csv", "decoded.bin")
FRAMED_STAGES = ("payload.bin", "frame_symbols.csv", "demod_symbols.csv",
                 "decoded.bin", "frame_meta.csv")
IQ_ATOL = 1e-5


def _jax():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from lora_sdr_lightweight_standalone_library_clean_tpu.runners import (
        vector_dump as jvd)
    from lora_sdr_lightweight_standalone_library_clean_tpu.utils import (
        vectors as jvec)
    return jvd, jvec


def _iq(path):
    return np.loadtxt(path, delimiter=",", dtype=np.float64, ndmin=2)


def _both(tmp_path, flags):
    jvd, _ = _jax()
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    assert jvd.main([f"--out={jdir}", *flags]) == 0
    assert tvd.main([f"--out={tdir}", *flags, "--device", "cpu"]) == 0
    return jdir, tdir


# sf12 takes 4 bytes: the JAX package's dump sizes the demod buffer to
# whole interleaver blocks of sf codewords, 8 symbols per block, which
# holds the 2 * bytes demod symbols only while bytes <= 4 * ceil(2 *
# bytes / 12)
@pytest.mark.parametrize("flags", [
    ["--sf=7", "--bytes=8", "--seed=3"],
    ["--sf=8", "--bytes=10", "--seed=4", "--window=hann", "--cfo-bins=0.3",
     "--time-offset=3"],
    ["--sf=12", "--bytes=4", "--seed=1"],
    ["--sf=7", "--bytes=8", "--seed=2", "--osr=2"],
], ids=["sf7", "sf8-hann-cfo-shift", "sf12", "sf7-osr2"])
def test_unframed_stages_match_jax(tmp_path, flags):
    jdir, tdir = _both(tmp_path, flags)
    for name in INTEGER_STAGES:
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes(), name
    np.testing.assert_allclose(_iq(tdir / "iq_samples.csv"),
                               _iq(jdir / "iq_samples.csv"), atol=IQ_ATOL,
                               rtol=0)


def test_framed_stages_match_jax(tmp_path):
    jdir, tdir = _both(tmp_path, ["--sf=7", "--bytes=9", "--seed=3",
                                  "--framed"])
    for name in FRAMED_STAGES:
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes(), name
    np.testing.assert_allclose(_iq(tdir / "iq_samples.csv"),
                               _iq(jdir / "iq_samples.csv"), atol=IQ_ATOL,
                               rtol=0)
    assert (tdir / "decoded.bin").read_bytes() == \
        (tdir / "payload.bin").read_bytes()


def test_framed_with_noise_decodes(tmp_path):
    """AWGN from a torch.Generator seeded with --seed: not JAX's noise, so
    only the port's own decode is checked."""
    out = tmp_path / "port"
    assert tvd.main([f"--out={out}", "--sf=8", "--bytes=12", "--seed=6",
                     "--framed", "--snr-db=5", "--device", "cpu"]) == 0
    assert (out / "decoded.bin").read_bytes() == \
        (out / "payload.bin").read_bytes()
    assert "crc_ok,1" in (out / "frame_meta.csv").read_text()


def test_dump_selects_stages(tmp_path):
    out = tmp_path / "port"
    assert tvd.main([f"--out={out}", "--sf=7", "--bytes=4", "--dump=payload",
                     "--dump=decoded", "--device", "cpu"]) == 0
    assert sorted(p.name for p in out.iterdir()) == ["decoded.bin",
                                                    "payload.bin"]


def test_mt19937_payload_matches_jax():
    jvd, _ = _jax()
    for seed in range(21):
        np.testing.assert_array_equal(tvd._mt19937_payload(seed, 64),
                                      jvd._mt19937_payload(seed, 64))


# ---------------------------------------------------------------------------
# utils/vectors.py: the readers on synthetic blobs of every format
# ---------------------------------------------------------------------------

def _crc_blob(rng):
    recs = []
    for _ in range(3):
        n = int(rng.integers(1, 9))
        recs.append(struct.pack("<BI", 0, n) + rng.bytes(n)
                    + struct.pack("<HB", int(rng.integers(0, 65536)), 1))
    return struct.pack("<I", len(recs)) + b"".join(recs)


def _hamming_blob(rng):
    recs = [struct.pack("<BBBBBB", 0, *rng.integers(0, 256, 3), 1, 0),
            struct.pack("<BBBBB", 1, *rng.integers(0, 128, 3), 0)]
    return struct.pack("<I", len(recs)) + b"".join(recs)


def _interleaver_blob(rng):
    ncw, nsym = 7, 8
    rec = (struct.pack("<BII", 0, 7, ncw) + rng.bytes(ncw)
           + struct.pack("<I", nsym)
           + rng.integers(0, 65536, nsym).astype("<u2").tobytes()
           + rng.bytes(ncw) + struct.pack("<B", 1))
    return struct.pack("<I", 1) + rec


def _sync_blob(rng):
    recs = [struct.pack("<BIBB", 0, sf, 0x12 + sf, sf % 2)
            for sf in (7, 9, 12)]
    return struct.pack("<I", len(recs)) + b"".join(recs)


def _detection_blob(rng):
    nsym, nsamp = 3, 16
    rec = (struct.pack("<BIIII", 0, 7, 125, 5, nsym)
           + rng.integers(0, 128, nsym).astype("<u4").tobytes()
           + struct.pack("<I", nsamp)
           + rng.standard_normal(2 * nsamp).astype("<f8").tobytes())
    return struct.pack("<I", 1) + rec


def _performance_blob(rng):
    recs = [struct.pack("<BIIIdd", 0, 7 + k, 125, 100 * k,
                        *rng.standard_normal(2)) for k in range(2)]
    return struct.pack("<I", len(recs)) + b"".join(recs)


def _modulation_blob(rng):
    n, nsamp = 5, 12
    rec = (struct.pack("<IIIII", 7 << 8, 125 << 8, 5 << 8, 3 << 8, n << 8)
           + b"\0" + rng.bytes(n) + struct.pack("<I", nsamp)
           + rng.standard_normal(2 * nsamp).astype("<f8").tobytes())
    return struct.pack("<I", 1) + rec


BLOBS = {"read_crc_tests": _crc_blob,
         "read_hamming_tests": _hamming_blob,
         "read_interleaver_tests": _interleaver_blob,
         "read_sync_word_tests": _sync_blob,
         "read_detection_tests": _detection_blob,
         "read_performance_tests": _performance_blob,
         "read_modulation_tests": _modulation_blob}


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b


@pytest.mark.parametrize("reader", sorted(BLOBS))
def test_readers_match_jax(tmp_path, reader):
    _, jvec = _jax()
    path = tmp_path / "blob.bin"
    path.write_bytes(BLOBS[reader](np.random.default_rng(len(reader))))
    got = getattr(tvec, reader)(path)
    assert got
    _same(got, getattr(jvec, reader)(path))


def test_b64_iq_roundtrip_and_truncation(tmp_path):
    _, jvec = _jax()
    iq = (np.random.default_rng(3).standard_normal((2, 33))
          .astype(np.float32))
    iq = (iq[0] + 1j * iq[1]).astype(np.complex64)
    path = tmp_path / "iq.b64"
    tvec.write_b64_iq(path, iq)
    np.testing.assert_array_equal(tvec.read_b64_iq(path), iq)
    np.testing.assert_array_equal(jvec.read_b64_iq(path), iq)
    # cut mid-sample: the partial trailing pair is dropped
    raw = base64.b64decode(path.read_text())[:-5]
    path.write_text(base64.b64encode(raw).decode())
    got = tvec.read_b64_iq(path)
    np.testing.assert_array_equal(got, iq[:-1])
    np.testing.assert_array_equal(got, jvec.read_b64_iq(path))
