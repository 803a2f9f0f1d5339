"""The port at sf10-sf12 (n = 1024 ... 4096) against the JAX package.

The plain versions of the factored TX kernel and the large-n RX kernel are
held to the JAX package's Pallas kernels in interpret mode
(``_tx_kernel_factored``; ``_rx_kernel`` with its hybrid DFT), with the
tolerances of tests/test_pallas.py, and the packet pipeline runs end to end
at sf10 and sf12.  These are the suite's heaviest port cases, kept in one
file of their own so that a worker of a parallel run takes them alone.
"""
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
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.models import (  # noqa: E402
    modem as tmodem)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.ops import (  # noqa: E402
    cuda_rx, cuda_tx)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.ops.chirp import (  # noqa: E402
    _with_sync_prelude)

torch.set_num_threads(1)


@pytest.mark.parametrize("sf,bw,dechirp,atol", [
    (10, 125000, False, 2e-6), (10, 125000, True, 4e-6),
    (11, 125000, False, 2e-6), (11, 125000, True, 4e-6),
    (12, 125000, False, 2e-6), (12, 125000, True, 4e-6),
    (12, 500000, False, 2e-6), (12, 500000, True, 4e-6),
])
def test_tx_ref_matches_pallas_tx_factored(sf, bw, dechirp, atol):
    """Symbols over the full tone range, so every digit-table row is used:
    IQ within 2e-6 (4e-6 with the folded down-chirp), the tolerances of
    tests/test_pallas.py:290-302."""
    n = 1 << sf
    syms = np.random.default_rng(sf).integers(0, n, (2, 6)).astype(np.int32)
    jp = J.LoraParams(sf=sf, bw=bw)
    wr, wi = pallas_tx.tx_tone_synth(j_prelude(jnp.asarray(syms), jp), jp,
                                     amplitude=0.75, dechirp=dechirp,
                                     interpret=True)
    tp = T.LoraParams(sf=sf, bw=bw)
    gr, gi = cuda_tx.tx_tone_synth_ref(
        _with_sync_prelude(torch.as_tensor(syms), tp), tp, amplitude=0.75,
        dechirp=dechirp)
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), atol=atol, rtol=0)
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), atol=atol, rtol=0)


def _rx_inputs(sf, seed, packets=4):
    """Real pre-dechirped packets with AWGN (sigma 0.03), t_off including 0
    and +-step, rate ~ N(0, 1e-4), scale in [0.5, 1]
    (tests/test_pallas.py:94-107)."""
    p = J.LoraParams(sf=sf)
    step = p.step
    rng = np.random.default_rng(seed)
    payloads = rng.integers(0, 256, (packets, 4)).astype(np.uint8)
    dr, di = J.dechirp(*J.modulate(J.encode(payloads), p), p)
    dr = np.asarray(dr) + rng.standard_normal(dr.shape).astype(np.float32) * 0.03
    di = np.asarray(di) + rng.standard_normal(di.shape).astype(np.float32) * 0.03
    t_off = rng.integers(-step, step + 1, packets).astype(np.int32)
    t_off[:3] = [0, step, -step]
    rate = (rng.standard_normal(packets) * 1e-4).astype(np.float32)
    scale = rng.uniform(0.5, 1.0, packets).astype(np.float32)
    return dr, di, t_off, rate, scale


@pytest.mark.parametrize("mult", ["ones", "downchirp_hann"])
@pytest.mark.parametrize("sf", [10, 12])
def test_rx_ref_matches_pallas_rx_hybrid(sf, mult):
    """The hybrid-DFT RX (n = 1024, 4096) with ones and with the full-RX
    down-chirp x Hann multiplier: bins exact, dB within rtol 1e-3, atol
    0.05 (tests/test_pallas.py:127-131)."""
    n = 1 << sf
    dr, di, t_off, rate, scale = _rx_inputs(sf, sf)
    if mult == "ones":
        mr, mi = np.ones(n, np.float32), np.zeros(n, np.float32)
    else:
        mr, mi = tmodem._full_rx_mult(sf, 1, T.Window.HANN)
    jp = J.LoraParams(sf=sf)
    wi_, wp, wa = pallas_rx.rx_window_detect(
        *(jnp.asarray(a) for a in (dr, di, t_off, rate, scale, mr, mi)), jp,
        interpret=True)
    gi_, gp, ga = cuda_rx.rx_window_detect_ref(
        *(torch.as_tensor(a) for a in (dr, di, t_off, rate, scale, mr, mi)),
        T.LoraParams(sf=sf))
    np.testing.assert_array_equal(gi_.numpy(), np.asarray(wi_))
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=1e-3,
                               atol=0.05)
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), rtol=1e-3,
                               atol=0.05)


@pytest.mark.parametrize("sf", [10, 12])
def test_slice_matches_jax(sf):
    """``encode -> modulate_dechirped -> demodulate_tones -> decode`` at
    BW125 on CRC-valid and altered payloads: IQ within 4e-6; symbols, sync
    word, bytes and ``crc_ok`` exact; CFO within 1e-5, timing within 1e-3
    samples, dB within 0.05."""
    rng = np.random.default_rng(100 + sf)
    pay = rng.integers(0, 256, (4, 8)).astype(np.uint8)
    crc = np.asarray(J.crc_sx1272(pay[:, 2:6])).astype(np.int64)
    pay[:, 6] = crc & 0xFF
    pay[:, 7] = crc >> 8
    pay[::3, 3] ^= 0x5A
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
    np.testing.assert_allclose(tdi.numpy(), np.asarray(jdi), atol=4e-6,
                               rtol=0)
    np.testing.assert_array_equal(tres.symbols.numpy(),
                                  np.asarray(jres.symbols))
    np.testing.assert_array_equal(tres.sync_word.numpy(),
                                  np.asarray(jres.sync_word))
    assert (tres.sync_word.numpy() == 0x12).all()
    np.testing.assert_array_equal(tdec.numpy(), pay)
    np.testing.assert_array_equal(tdec.numpy(), np.asarray(jdec))
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
