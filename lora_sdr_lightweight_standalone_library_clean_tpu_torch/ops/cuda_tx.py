"""Dense TX chirp synthesis: the hand-written CUDA kernel and its plain form.

Counterpart of ``lora_sdr_lightweight_standalone_library_clean_tpu/ops/
pallas_tx.py`` for osr == 1 and n <= 512, the kernel ``_tx_kernel`` that
``_tx_call`` runs.  At osr == 1 every chirp row of a packet is

    out[b, s, :] = sgn[s] * (wc2, ws2)[tone[b, s], :],  tone = (sym*bs) mod n

with the (n, n) tone tables premultiplied by base chirp x amplitude (x the
demod down-chirp when ``dechirp=True``), folded on the host exactly as
``_tx_call`` folds them, and ``sgn`` alternating +-1 along the symbols when
bs is odd (``pallas_tx.py:582``).

``tx_tone_synth`` lets the device of its input decide: on a CPU tensor it
runs ``tx_tone_synth_ref``, the same row lookup in PyTorch; on a CUDA tensor
it launches ``csrc/tx_dense.cu`` (built by ``utils/cuda_build.py``) or
raises.  Every launch adds one to ``KERNEL_LAUNCHES``.

Kernel note.  Replaces ``ops/pallas_tx.py:_tx_kernel``.  The TPU forms the
lookup as a one-hot matmul; on the H100 it is a gather with no arithmetic,
bound by the 8 bytes it stores per output sample (the tables stay in L2).
The kernel therefore spends its design on the store stream: one float4 of
re and one of im per thread, neighbouring threads on neighbouring
addresses.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import cuda_build
from ..utils.config import LoraParams
from ..utils.tensors import device_table, int_tensor
from .chirp import _tx_base_chirp, _tx_tone_tables, downchirp_ri

__all__ = ["tx_supported", "tx_tone_synth", "tx_tone_synth_ref",
           "KERNEL_LAUNCHES", "TX_MAX_N"]

TX_MAX_N = 512
KERNEL_LAUNCHES = 0


def tx_supported(n: int, osr: int) -> bool:
    """True when the dense TX kernel covers this configuration."""
    return osr == 1 and n <= TX_MAX_N


def _require_supported(params: LoraParams) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item for what
    ``tx_supported`` rejects."""
    if tx_supported(params.n, params.osr):
        return
    if params.osr != 1:
        raise NotImplementedError(
            f"TX synthesis at osr={params.osr} is not ported yet: it is "
            "ROADMAP kernel item #3 (ops/pallas_tx.py::_tx_osr_kernel)")
    raise NotImplementedError(
        f"TX synthesis at n={params.n} is not ported yet: it is ROADMAP "
        "kernel item #2 (ops/pallas_tx.py::_tx_kernel_factored)")


def _tx_tables(n: int, bs: int, amplitude: float, dechirp: bool):
    """Premultiplied (n, n) float32 tone tables, folded as ``_tx_call``
    (``pallas_tx.py:134-140``) and ``tx_tone_synth`` (``:576-581``) fold
    them: base chirp x amplitude (x down-chirp) into the table columns."""
    wc, ws = _tx_tone_tables(n)
    bc, bsn = _tx_base_chirp(n, bs)
    amp = np.float32(amplitude)
    mr = (amp * bc).astype(np.float32)
    mi = (amp * bsn).astype(np.float32)
    if dechirp:
        dcr, dci = downchirp_ri(n.bit_length() - 1, bs)
        mr, mi = mr * dcr - mi * dci, mr * dci + mi * dcr
    wc2 = wc * mr[None, :] - ws * mi[None, :]
    ws2 = ws * mr[None, :] + wc * mi[None, :]
    return wc2, ws2


def _row_signs(s_total: int, bs: int, n: int, device) -> torch.Tensor | None:
    """The alternating carried-phase sign per symbol row (bs odd)."""
    if not (bs * n) % (2 * n):
        return None
    sgn = np.where(np.arange(s_total) % 2 == 0, 1.0, -1.0).astype(np.float32)
    return torch.as_tensor(sgn, device=device)


def tx_tone_synth_ref(symbols_with_sync, params: LoraParams,
                      amplitude: float = 1.0, dechirp: bool = False):
    """Plain PyTorch version of the TX kernel: table rows by
    ``index_select``, then the row sign.

    Args:
      symbols_with_sync: integer (..., S+2) symbol values, sync chirps first
        (``ops/chirp.py::_with_sync_prelude``).
      dechirp: also multiply by the demod down-chirp, so the output is the
        pre-dechirped stream.

    Returns (re, im) float32 of shape (..., (S+2) * n), on the input's device.
    """
    _require_supported(params)
    n, bs = params.n, params.bw_scale
    amp = float(np.float32(np.clip(amplitude, -1.0, 1.0)))  # LoRaMod.cpp:18
    sym = int_tensor(symbols_with_sync)
    lead, s_total = sym.shape[:-1], sym.shape[-1]
    wc2, ws2 = device_table(_tx_tables, n, bs, amp, bool(dechirp),
                            device=sym.device)
    tone = torch.remainder(sym * bs, n).reshape(-1)
    re = wc2.index_select(0, tone).reshape(-1, s_total, n)
    im = ws2.index_select(0, tone).reshape(-1, s_total, n)
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
    version; a CUDA input launches ``csrc/tx_dense.cu`` and raises
    ``NotImplementedError`` for osr > 1 or n > 512.
    """
    global KERNEL_LAUNCHES
    sym = int_tensor(symbols_with_sync, torch.int32)
    if not sym.is_cuda:
        return tx_tone_synth_ref(sym, params, amplitude, dechirp)
    _require_supported(params)
    n, bs = params.n, params.bw_scale
    amp = float(np.float32(np.clip(amplitude, -1.0, 1.0)))  # LoRaMod.cpp:18
    sym = sym.contiguous()
    lead, s_total = sym.shape[:-1], sym.shape[-1]
    rows = sym.numel()
    if rows * n >= 2 ** 31:
        raise ValueError(f"{rows} symbol rows of {n} samples exceed the "
                         "kernel's 32-bit sample indexing")
    wc2, ws2 = device_table(_tx_tables, n, bs, amp, bool(dechirp),
                            device=sym.device)
    out = lead + (s_total * n,)
    re = torch.empty(out, dtype=torch.float32, device=sym.device)
    im = torch.empty(out, dtype=torch.float32, device=sym.device)
    if rows == 0:
        return re, im
    lib = cuda_build.load()
    alt_sign = int(bool((bs * n) % (2 * n)))
    with torch.cuda.device(sym.device):
        err = lib.lora_tx_dense(
            sym.data_ptr(), rows, s_total, n, bs, alt_sign,
            wc2.data_ptr(), ws2.data_ptr(), re.data_ptr(), im.data_ptr(),
            torch.cuda.current_stream(sym.device).cuda_stream)
    if err:
        raise RuntimeError(f"lora_tx_dense launch failed: cudaError_t {err}")
    KERNEL_LAUNCHES += 1
    return re, im
