"""TX chirp synthesis: the hand-written CUDA kernels and their plain form.

Counterpart of ``lora_sdr_lightweight_standalone_library_clean_tpu/ops/
pallas_tx.py`` for osr == 1, the kernels that ``tx_tone_synth`` runs there:
``_tx_kernel`` (dense tables, n <= 512) and ``_tx_kernel_factored``
(digit tables, n = 1024 ... 4096).  At osr == 1 every chirp row of a
packet is

    out[b, s, m] = sgn[s] * amp * base[m] (* downchirp[m]) * w^(t*(m+1)),
    t = (sym*bs) mod n,  w = exp(2j*pi/n),

with ``sgn`` alternating +-1 along the symbols when bs is odd
(``pallas_tx.py:582``).  The two forms round this product as the JAX
package's kernels do:

* dense (n <= 512): the (n, n) tone tables premultiplied by base chirp x
  amplitude (x the demod down-chirp when ``dechirp=True``), folded on the
  host exactly as ``_tx_call`` folds them, and one table row per symbol;
* factored (n >= 1024): ``w^(t*m') = w1[t mod n1, m1] * w2[t, m2]`` for the
  digits m' = (m+1) mod n = m1*128 + m2, with w2's columns rolled by -1 so
  lane j of block m1 takes the m2 = (j+1) mod 128 digit and the last lane
  its w1 factor from column m1+1, then the folded multiplier laid out by
  output column (``_tx_kernel_factored``, ``pallas_tx.py:177-232``).  The
  dense table would be 2 x 64 MB at n = 4096.

``tx_tone_synth`` lets the device of its input decide: on a CPU tensor it
runs ``tx_tone_synth_ref``, the same arithmetic in PyTorch; on a CUDA tensor
it launches ``csrc/tx_dense.cu`` (n <= 512) or ``csrc/tx_factored.cu``
(n = 1024 ... 4096), built by ``utils/cuda_build.py``, or raises.  Each
launch adds one to its kernel's count (``DENSE_LAUNCHES`` or
``FACTORED_LAUNCHES``) and to their sum ``KERNEL_LAUNCHES``.

Kernel note.  Replaces ``ops/pallas_tx.py:_tx_kernel`` and
``ops/pallas_tx.py:_tx_kernel_factored``.  The TPU forms the lookups as
one-hot matmuls; on the H100 they are gathers with at most a few
multiplies, bound by the 8 bytes stored per output sample.  Both kernels
spend their design on the store stream: float4 stores of re and of im,
neighbouring threads on neighbouring addresses, with the tables in L2.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import cuda_build
from ..utils.config import LoraParams
from ..utils.tensors import device_table, int_tensor
from .chirp import (_tx_base_chirp, _tx_tone_tables, _tx_tone_tables_factored,
                    downchirp_ri)

__all__ = ["tx_supported", "tx_tone_synth", "tx_tone_synth_ref",
           "KERNEL_LAUNCHES", "DENSE_LAUNCHES", "FACTORED_LAUNCHES",
           "TX_DENSE_MAX_N", "TX_MAX_N"]

TX_DENSE_MAX_N = 512      # dense (n, n) tone tables (pallas_tx.PALLAS_TX_MAX_N)
TX_MAX_N = 4096           # factored digit tables (PALLAS_TX_MAX_N_FACTORED)
TX_N2 = 128               # the factored form's second digit base
DENSE_LAUNCHES = 0
FACTORED_LAUNCHES = 0
KERNEL_LAUNCHES = 0       # DENSE_LAUNCHES + FACTORED_LAUNCHES


def tx_supported(n: int, osr: int) -> bool:
    """True when a TX kernel covers this configuration."""
    return osr == 1 and n <= TX_MAX_N


def _require_supported(params: LoraParams) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item for what
    ``tx_supported`` rejects."""
    if tx_supported(params.n, params.osr):
        return
    raise NotImplementedError(
        f"TX synthesis at osr={params.osr} is not ported yet: it is "
        "ROADMAP kernel item #3 (ops/pallas_tx.py::_tx_osr_kernel)")


def _tx_mult(n: int, bs: int, amplitude: float, dechirp: bool):
    """(n,) float32 base chirp x amplitude (x down-chirp), as
    ``tx_tone_synth`` folds it (``pallas_tx.py:576-581``)."""
    bc, bsn = _tx_base_chirp(n, bs)
    amp = np.float32(amplitude)
    mr = (amp * bc).astype(np.float32)
    mi = (amp * bsn).astype(np.float32)
    if dechirp:
        dcr, dci = downchirp_ri(n.bit_length() - 1, bs)
        mr, mi = mr * dcr - mi * dci, mr * dci + mi * dcr
    return mr, mi


def _tx_tables(n: int, bs: int, amplitude: float, dechirp: bool):
    """Premultiplied (n, n) float32 tone tables, folded as ``_tx_call``
    (``pallas_tx.py:134-140``) folds them: the multiplier into the
    table columns."""
    wc, ws = _tx_tone_tables(n)
    mr, mi = _tx_mult(n, bs, amplitude, dechirp)
    wc2 = wc * mr[None, :] - ws * mi[None, :]
    ws2 = ws * mr[None, :] + wc * mi[None, :]
    return wc2, ws2


def _tx_digit_tables(n: int):
    """The factored form's digit tables as ``_tx_call_factored`` lays them
    out (``pallas_tx.py:251-260``): w1 (n1, n1) and w2 (n, 128) with its
    columns rolled by -1."""
    w1c, w1s, w2c, w2s = _tx_tone_tables_factored(n, TX_N2)
    return (w1c, w1s, np.roll(w2c, -1, axis=1), np.roll(w2s, -1, axis=1))


def _factored_rows(tone, n: int, w1c, w1s, w2c, w2s, mr, mi):
    """``_tx_kernel_factored``'s arithmetic on (rows,) tones -> (rows, n)."""
    n1 = n // TX_N2
    f2c = w2c.index_select(0, tone)[:, None, :]                # (R, 1, n2)
    f2s = w2s.index_select(0, tone)[:, None, :]
    t1 = torch.remainder(tone, n1)
    f1c = w1c.index_select(0, t1)                              # (R, n1)
    f1s = w1s.index_select(0, t1)
    # lane n2-1 takes its w1 factor from the next digit block m1+1
    last = torch.arange(TX_N2, device=tone.device) == TX_N2 - 1
    gc = torch.where(last, torch.roll(f1c, -1, dims=-1)[..., None],
                     f1c[..., None])                           # (R, n1, n2)
    gs = torch.where(last, torch.roll(f1s, -1, dims=-1)[..., None],
                     f1s[..., None])
    tc = gc * f2c - gs * f2s
    ts = gc * f2s + gs * f2c
    mr = mr.reshape(n1, TX_N2)
    mi = mi.reshape(n1, TX_N2)
    re = tc * mr - ts * mi
    im = ts * mr + tc * mi
    return re.reshape(-1, n), im.reshape(-1, n)


def _row_signs(s_total: int, bs: int, n: int, device) -> torch.Tensor | None:
    """The alternating carried-phase sign per symbol row (bs odd)."""
    if not (bs * n) % (2 * n):
        return None
    sgn = np.where(np.arange(s_total) % 2 == 0, 1.0, -1.0).astype(np.float32)
    return torch.as_tensor(sgn, device=device)


def _amp(amplitude: float) -> float:
    return float(np.float32(np.clip(amplitude, -1.0, 1.0)))  # LoRaMod.cpp:18


def tx_tone_synth_ref(symbols_with_sync, params: LoraParams,
                      amplitude: float = 1.0, dechirp: bool = False):
    """Plain PyTorch version of the TX kernels: dense table rows by
    ``index_select`` (n <= 512) or the factored digit products
    (n >= 1024), then the row sign.

    Args:
      symbols_with_sync: integer (..., S+2) symbol values, sync chirps first
        (``ops/chirp.py::_with_sync_prelude``).
      dechirp: also multiply by the demod down-chirp, so the output is the
        pre-dechirped stream.

    Returns (re, im) float32 of shape (..., (S+2) * n), on the input's device.
    """
    _require_supported(params)
    n, bs = params.n, params.bw_scale
    amp = _amp(amplitude)
    sym = int_tensor(symbols_with_sync)
    lead, s_total = sym.shape[:-1], sym.shape[-1]
    tone = torch.remainder(sym * bs, n).reshape(-1)
    if n <= TX_DENSE_MAX_N:
        wc2, ws2 = device_table(_tx_tables, n, bs, amp, bool(dechirp),
                                device=sym.device)
        re = wc2.index_select(0, tone)
        im = ws2.index_select(0, tone)
    else:
        tabs = device_table(_tx_digit_tables, n, device=sym.device)
        mult = device_table(_tx_mult, n, bs, amp, bool(dechirp),
                            device=sym.device)
        re, im = _factored_rows(tone, n, *tabs, *mult)
    re = re.reshape(-1, s_total, n)
    im = im.reshape(-1, s_total, n)
    sgn = _row_signs(s_total, bs, n, sym.device)
    if sgn is not None:
        re = re * sgn[:, None]
        im = im * sgn[:, None]
    out = lead + (s_total * n,)
    return re.reshape(out), im.reshape(out)


def tx_tone_synth(symbols_with_sync, params: LoraParams,
                  amplitude: float = 1.0, dechirp: bool = False):
    """Synthesize packets' chirps (sync prelude included by the caller).

    Same contract as ``tx_tone_synth_ref``.  A CPU input runs the plain
    version; a CUDA input launches ``csrc/tx_dense.cu`` (n <= 512) or
    ``csrc/tx_factored.cu`` (n = 1024 ... 4096) and raises
    ``NotImplementedError`` for osr > 1.
    """
    global KERNEL_LAUNCHES, DENSE_LAUNCHES, FACTORED_LAUNCHES
    sym = int_tensor(symbols_with_sync, torch.int32)
    if not sym.is_cuda:
        return tx_tone_synth_ref(sym, params, amplitude, dechirp)
    _require_supported(params)
    n, bs = params.n, params.bw_scale
    amp = _amp(amplitude)
    sym = sym.contiguous()
    lead, s_total = sym.shape[:-1], sym.shape[-1]
    rows = sym.numel()
    if rows >= 2 ** 31:
        raise ValueError(f"{rows} symbol rows exceed the kernels' 32-bit "
                         "row indexing")
    out = lead + (s_total * n,)
    re = torch.empty(out, dtype=torch.float32, device=sym.device)
    im = torch.empty(out, dtype=torch.float32, device=sym.device)
    if rows == 0:
        return re, im
    lib = cuda_build.load()
    alt_sign = int(bool((bs * n) % (2 * n)))
    stream = torch.cuda.current_stream(sym.device).cuda_stream
    dense = n <= TX_DENSE_MAX_N
    with torch.cuda.device(sym.device):
        if dense:
            wc2, ws2 = device_table(_tx_tables, n, bs, amp, bool(dechirp),
                                    device=sym.device)
            err = lib.lora_tx_dense(
                sym.data_ptr(), rows, s_total, n, bs, alt_sign,
                wc2.data_ptr(), ws2.data_ptr(), re.data_ptr(), im.data_ptr(),
                stream)
        else:
            w1c, w1s, w2c, w2s = device_table(_tx_digit_tables, n,
                                              device=sym.device)
            mr, mi = device_table(_tx_mult, n, bs, amp, bool(dechirp),
                                  device=sym.device)
            err = lib.lora_tx_factored(
                sym.data_ptr(), rows, s_total, n, bs, alt_sign,
                w1c.data_ptr(), w1s.data_ptr(), w2c.data_ptr(),
                w2s.data_ptr(), mr.data_ptr(), mi.data_ptr(), re.data_ptr(),
                im.data_ptr(), stream)
    name = "lora_tx_dense" if dense else "lora_tx_factored"
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
    KERNEL_LAUNCHES += 1
    if dense:
        DENSE_LAUNCHES += 1
    else:
        FACTORED_LAUNCHES += 1
    return re, im
