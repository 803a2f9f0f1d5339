"""TX chirp synthesis: the hand-written CUDA kernels and their plain form.

Counterpart of ``lora_sdr_lightweight_standalone_library_clean_tpu/ops/
pallas_tx.py``, the kernels that ``tx_tone_synth`` runs there:
``_tx_kernel`` (osr == 1, dense tables, n <= 512), ``_tx_kernel_factored``
(osr == 1, digit tables, n = 1024 ... 4096) and ``_tx_osr_kernel`` (osr >
1).  At osr == 1 every chirp row of a packet is

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

At osr > 1 (``_tx_osr_kernel``, ``pallas_tx.py:296-391``) each symbol of
n*osr samples is written as bs chunk rows of q = n*osr/bs samples: chunk row
r = s*bs + k holds samples k*q ... (k+1)*q - 1 of symbol s, and

    out[r, j] = (w^(t*(j+1)) * wt[j]^(g1 + g2)) * mult[class(r), j],
    t = sym mod q,  w = exp(2j*pi/q),  wt[j] = exp(-2j*pi*bs*(j+1)/osr),

with the tone factor from the dense (q, q) tables (q <= 512) or the digit
tables over modulus q (q > 512), the gates g1 = j >= n*osr - sym*osr - k*q
and g2 = j >= 2*n*osr - sym*osr - k*q (one factor of wt per frequency wrap,
statically off when osr divides bs), and ``mult`` the float64-exact
carry(s) x amplitude x base-chirp chunk (x down-chirp chunk) of
``_tx_osr_mult``.  The carry depends on s only through s mod P, the carry
period, so the multiplier is kept as P*bs rows (``class(r) = (s mod P)*bs +
k``), bit-equal to the JAX package's S*bs rows.

``tx_tone_synth`` lets the device of its input decide: on a CPU tensor it
runs ``tx_tone_synth_ref``, the same arithmetic in PyTorch; on a CUDA tensor
it launches ``csrc/tx_dense.cu`` (osr == 1, n <= 512), ``csrc/
tx_factored.cu`` (osr == 1, n = 1024 ... 4096) or ``csrc/tx_osr.cu`` (osr >
1, 128 <= q <= 4096), built by ``utils/cuda_build.py``, or raises.  The
launch path runs in the span ``lora.kernel.<kernel>``, and each launch adds
one to ``COUNTS["launch.<kernel>"]`` (``utils/spans.py``), the kernel being
``tx_dense``, ``tx_factored`` or ``tx_osr``.

Kernel note.  Replaces ``ops/pallas_tx.py:_tx_kernel``,
``ops/pallas_tx.py:_tx_kernel_factored`` and
``ops/pallas_tx.py:_tx_osr_kernel``.  The TPU forms the lookups as one-hot
matmuls; on the H100 they are gathers with at most a few multiplies, bound
by the 8 bytes stored per output sample.  All three kernels spend their
design on the store stream: float4 stores of re and of im, neighbouring
threads on neighbouring addresses, with the tables in L2.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..utils import cuda_build
from ..utils.config import LoraParams
from ..utils.errors import InvalidArgumentError
from ..utils.spans import count, span
from ..utils.tensors import device_table, int_tensor
from .chirp import (_tx_base_chirp, _tx_tone_tables, _tx_tone_tables_factored,
                    downchirp_ri)

__all__ = ["tx_supported", "tx_tone_synth", "tx_tone_synth_ref",
           "TX_DENSE_MAX_N", "TX_MAX_N", "TX_OSR_MIN_Q"]

TX_DENSE_MAX_N = 512      # dense (n, n) tone tables (pallas_tx.PALLAS_TX_MAX_N)
TX_MAX_N = 4096           # factored digit tables (PALLAS_TX_MAX_N_FACTORED)
TX_OSR_MIN_Q = 128        # osr > 1: tone modulus q in [128, 4096]
TX_N2 = 128               # the factored form's second digit base


def tx_supported(n: int, osr: int, bw_scale: int = 1) -> bool:
    """True when a TX kernel covers this configuration
    (``pallas_tx.py:48-65``): osr == 1 up to n = 4096; osr > 1 when n*osr
    is a multiple of bw_scale and 128 <= q = n*osr/bw_scale <= 4096."""
    if osr == 1:
        return n <= TX_MAX_N
    q, rem = divmod(n * osr, bw_scale)
    return rem == 0 and TX_OSR_MIN_Q <= q <= TX_MAX_N


def _require_supported(params: LoraParams) -> None:
    """Raise ``InvalidArgumentError`` for what ``tx_supported`` rejects:
    the JAX package synthesizes those configurations in closed form
    (``ops/chirp.py::modulate_ri``) and so does this port."""
    if tx_supported(params.n, params.osr, params.bw_scale):
        return
    raise InvalidArgumentError(
        f"sf{params.sf} osr={params.osr} bw_scale={params.bw_scale} is "
        "outside the TX kernels' domain (osr 1 to n = 4096; osr > 1 with "
        "tone modulus 128 <= n*osr/bw_scale <= 4096, ops/pallas_tx.py::"
        "tx_supported): modulate_ri synthesizes it in closed form")


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


def _carry_period(sf: int, bs: int, osr: int) -> int:
    """The period in s of the carry exp(j*pi*((s*b*bs) mod 2d)/d), b = n*osr,
    d = n*osr^2: 2d / gcd(b*bs, 2d) (2 to 16 for osr <= 8)."""
    n = 1 << sf
    b, d = n * osr, n * osr * osr
    return 2 * d // math.gcd(b * bs, 2 * d)


@functools.lru_cache(maxsize=None)
def _tx_osr_mult(sf: int, bs: int, osr: int, amplitude: float,
                 dechirp: bool):
    """``pallas_tx.py:394-425`` with one row class per carry phase: (P*bs, q)
    float32 multiplier rows carry(s) x amp x base-chirp chunk (x down-chirp
    chunk) for s = 0 ... P-1, from exact integer residues in float64, bit-
    equal to the JAX package's row s*bs + k for every s with the same
    s mod P.  Also the (q,) float32 wrap tone (wtc, wts)."""
    n = 1 << sf
    nn = n * osr
    d = n * osr * osr
    b = n * osr
    q = nn // bs
    m = np.arange(1, nn + 1, dtype=np.int64)
    bnum = np.mod(bs * (m * (m + 1) - m * b), 2 * d)
    base = amplitude * np.exp(1j * np.pi * bnum.astype(np.float64) / d)
    if dechirp:
        dcr, dci = downchirp_ri(sf, bs, osr)
        base = base * (dcr.astype(np.float64) + 1j * dci.astype(np.float64))
    s_idx = np.arange(_carry_period(sf, bs, osr), dtype=np.int64)
    carry = np.exp(1j * np.pi
                   * np.mod(s_idx * b * bs, 2 * d).astype(np.float64) / d)
    mult = (carry[:, None, None] * base.reshape(bs, q)[None]).reshape(-1, q)
    wt = np.exp(-2j * np.pi * bs * m[:q].astype(np.float64) / osr)
    return (np.ascontiguousarray(mult.real).astype(np.float32),
            np.ascontiguousarray(mult.imag).astype(np.float32),
            wt.real.astype(np.float32), wt.imag.astype(np.float32))


def _factored_tones(tone, n: int, w1c, w1s, w2c, w2s):
    """The digit-table tone factor of ``_tx_kernel_factored`` (and of
    ``_tx_osr_kernel`` over modulus n = q) on (rows,) tones -> (rows, n)."""
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
    return tc.reshape(-1, n), ts.reshape(-1, n)


def _row_signs(s_total: int, bs: int, n: int, device) -> torch.Tensor | None:
    """The alternating carried-phase sign per symbol row (bs odd)."""
    if not (bs * n) % (2 * n):
        return None
    sgn = np.where(np.arange(s_total) % 2 == 0, 1.0, -1.0).astype(np.float32)
    return torch.as_tensor(sgn, device=device)


def _amp(amplitude: float) -> float:
    return float(np.float32(np.clip(amplitude, -1.0, 1.0)))  # LoRaMod.cpp:18


def _osr_ref(sym, params: LoraParams, amp: float, dechirp: bool):
    """``_tx_osr_kernel``'s arithmetic as gathers (``pallas_tx.py:328-391``):
    tone rows, the two wrap gates, then the multiplier rows.  (B, S) int64
    symbols -> (re, im) (B, S*bs, q)."""
    n, osr, bs = params.n, params.osr, params.bw_scale
    b_samp = n * osr
    q = b_samp // bs
    dev = sym.device
    bcount, s_total = sym.shape
    t = torch.remainder(sym, q)[..., None].expand(bcount, s_total, bs)
    tone = t.reshape(-1)
    if q <= TX_DENSE_MAX_N:
        wc, ws = device_table(_tx_tone_tables, q, device=dev)
        c = wc.index_select(0, tone)
        s_ = ws.index_select(0, tone)
    else:
        tabs = device_table(_tx_digit_tables, q, device=dev)
        c, s_ = _factored_tones(tone, q, *tabs)
    mr, mi, wtc, wts = device_table(_tx_osr_mult, params.sf, bs, osr, amp,
                                    bool(dechirp), device=dev)
    if bs % osr:                                     # gated (wt != 1)
        lane = torch.arange(q, device=dev)
        kq = torch.arange(bs, device=dev) * q
        thr1 = ((b_samp - sym * osr)[..., None] - kq).reshape(-1, 1)
        for thr in (thr1, thr1 + b_samp):
            g = lane >= thr
            c, s_ = (torch.where(g, c * wtc - s_ * wts, c),
                     torch.where(g, c * wts + s_ * wtc, s_))
    period = _carry_period(params.sf, bs, osr)
    cls = ((torch.arange(s_total, device=dev) % period)[:, None] * bs
           + torch.arange(bs, device=dev)).reshape(-1)
    c = c.reshape(bcount, s_total * bs, q)
    s_ = s_.reshape(bcount, s_total * bs, q)
    mr = mr.index_select(0, cls)                     # (S*bs, q)
    mi = mi.index_select(0, cls)
    return c * mr - s_ * mi, c * mi + s_ * mr


def tx_tone_synth_ref(symbols_with_sync, params: LoraParams,
                      amplitude: float = 1.0, dechirp: bool = False):
    """Plain PyTorch version of the TX kernels: dense table rows by
    ``index_select`` (osr == 1, n <= 512) or the factored digit products
    (osr == 1, n >= 1024), then the row sign; at osr > 1 the tone rows over
    modulus q, the wrap gates and the carried multiplier rows.

    Args:
      symbols_with_sync: integer (..., S+2) symbol values, sync chirps first
        (``ops/chirp.py::_with_sync_prelude``).
      dechirp: also multiply by the demod down-chirp, so the output is the
        pre-dechirped stream.

    Returns (re, im) float32 of shape (..., (S+2) * n * osr), on the input's
    device.
    """
    _require_supported(params)
    n, bs = params.n, params.bw_scale
    amp = _amp(amplitude)
    sym = int_tensor(symbols_with_sync)
    lead, s_total = sym.shape[:-1], sym.shape[-1]
    out = lead + (s_total * params.step,)
    if params.osr > 1:
        re, im = _osr_ref(sym.reshape(-1, s_total), params, amp, dechirp)
        return re.reshape(out), im.reshape(out)
    tone = torch.remainder(sym * bs, n).reshape(-1)
    if n <= TX_DENSE_MAX_N:
        wc2, ws2 = device_table(_tx_tables, n, bs, amp, bool(dechirp),
                                device=sym.device)
        re = wc2.index_select(0, tone)
        im = ws2.index_select(0, tone)
    else:
        tabs = device_table(_tx_digit_tables, n, device=sym.device)
        mr, mi = device_table(_tx_mult, n, bs, amp, bool(dechirp),
                              device=sym.device)
        tc, ts = _factored_tones(tone, n, *tabs)
        re = tc * mr - ts * mi
        im = ts * mr + tc * mi
    re = re.reshape(-1, s_total, n)
    im = im.reshape(-1, s_total, n)
    sgn = _row_signs(s_total, bs, n, sym.device)
    if sgn is not None:
        re = re * sgn[:, None]
        im = im * sgn[:, None]
    return re.reshape(out), im.reshape(out)


def tx_tone_synth(symbols_with_sync, params: LoraParams,
                  amplitude: float = 1.0, dechirp: bool = False):
    """Synthesize packets' chirps (sync prelude included by the caller).

    Same contract as ``tx_tone_synth_ref``.  A CPU input runs the plain
    version; a CUDA input launches ``csrc/tx_dense.cu`` (osr == 1, n <=
    512), ``csrc/tx_factored.cu`` (osr == 1, n = 1024 ... 4096) or
    ``csrc/tx_osr.cu`` (osr > 1, 128 <= q <= 4096), and raises
    ``InvalidArgumentError`` outside that domain.
    """
    sym = int_tensor(symbols_with_sync, torch.int32)
    if not sym.is_cuda:
        return tx_tone_synth_ref(sym, params, amplitude, dechirp)
    n, bs, osr = params.n, params.bw_scale, params.osr
    kernel = ("tx_osr" if osr > 1 else
              "tx_dense" if n <= TX_DENSE_MAX_N else "tx_factored")
    with span("lora.kernel." + kernel):
        _require_supported(params)
        amp = _amp(amplitude)
        sym = sym.contiguous()
        dev = sym.device
        lead, s_total = sym.shape[:-1], sym.shape[-1]
        rows = sym.numel()
        if rows * (bs if osr > 1 else 1) >= 2 ** 31:
            raise ValueError(f"{rows} symbol rows exceed the kernels' "
                             "32-bit row indexing")
        out = lead + (s_total * params.step,)
        re = torch.empty(out, dtype=torch.float32, device=dev)
        im = torch.empty(out, dtype=torch.float32, device=dev)
        if rows == 0:
            return re, im
        lib = cuda_build.load()
        stream = torch.cuda.current_stream(dev).cuda_stream
        if kernel == "tx_osr":
            q = n * osr // bs
            if q <= TX_DENSE_MAX_N:
                tabs = (device_table(_tx_tone_tables, q, device=dev)
                        + (None, None))
            else:
                tabs = device_table(_tx_digit_tables, q, device=dev)
            mr, mi, wtc, wts = device_table(_tx_osr_mult, params.sf, bs,
                                            osr, amp, bool(dechirp),
                                            device=dev)
            ptr = [None if t is None else t.data_ptr() for t in tabs]
            with torch.cuda.device(dev):
                err = lib.lora_tx_osr(
                    sym.data_ptr(), rows, s_total, q, bs, osr,
                    _carry_period(params.sf, bs, osr), int(bool(bs % osr)),
                    *ptr, wtc.data_ptr(), wts.data_ptr(), mr.data_ptr(),
                    mi.data_ptr(), re.data_ptr(), im.data_ptr(), stream)
        elif kernel == "tx_dense":
            wc2, ws2 = device_table(_tx_tables, n, bs, amp, bool(dechirp),
                                    device=dev)
            with torch.cuda.device(dev):
                err = lib.lora_tx_dense(
                    sym.data_ptr(), rows, s_total, n, bs, _alt_sign(bs, n),
                    wc2.data_ptr(), ws2.data_ptr(), re.data_ptr(),
                    im.data_ptr(), stream)
        else:
            w1c, w1s, w2c, w2s = device_table(_tx_digit_tables, n,
                                              device=dev)
            mr, mi = device_table(_tx_mult, n, bs, amp, bool(dechirp),
                                  device=dev)
            with torch.cuda.device(dev):
                err = lib.lora_tx_factored(
                    sym.data_ptr(), rows, s_total, n, bs, _alt_sign(bs, n),
                    w1c.data_ptr(), w1s.data_ptr(), w2c.data_ptr(),
                    w2s.data_ptr(), mr.data_ptr(), mi.data_ptr(),
                    re.data_ptr(), im.data_ptr(), stream)
        if err:
            raise RuntimeError(
                f"lora_{kernel} launch failed: cudaError_t {err}")
        count("launch." + kernel)
        return re, im


def _alt_sign(bs: int, n: int) -> int:
    return int(bool((bs * n) % (2 * n)))
