"""Packet extraction and dechirp: a hand-written CUDA kernel and its plain
form.

The streaming receivers (``parallel/receiver.py::_demod_owned``) cut each
packet they recover out of the extended stream [tail | chunk] and multiply
it by the down-chirp, symbol by symbol, before the demodulator.  For rows
k < K and samples j < plen:

  (a) ``x = ext[pos[k] + j]`` on both planes;
  (b) ``dr = xr * dcr[j % step] - xi * dci[j % step]`` and
      ``di = xr * dci[j % step] + xi * dcr[j % step]``, with ``dcr``/``dci``
      the one-symbol down-chirp (``ops/chirp.py::downchirp_ri``).

``extract_dechirp`` lets the device of its input decide: on a CPU tensor
it runs ``extract_dechirp_ref``, the receivers' plain steps
(``unfold(...).index_select`` on each plane, then ``models/modem.py::
dechirp``); on a CUDA tensor it launches ``csrc/extract_dechirp.cu``.  The
launch path runs in the span ``lora.kernel.extract_dechirp``, and each
launch adds one to ``COUNTS["launch.extract_dechirp"]``
(``utils/spans.py``).  On the card it takes float32 (len,) planes, int64
(K,) starts and a ``plen`` that is a multiple of ``step``; anything else
raises ``InvalidArgumentError``.

Kernel note.  Replaces no TPU kernel: the JAX package's receiver slices
each packet with a vmapped ``lax.dynamic_slice_in_dim`` and dechirps it
with jnp, which XLA fuses on the TPU.  Eager PyTorch runs the same step as
eight kernels, each writing a full (K, plen) plane that the next one reads
back; the kernel reads each row's samples once and writes ``dr``/``di``
once, rounding each product and sum on its own as those kernels do, so its
rows are bit-equal to the plain version's.  Its bound is the written rows
plus one read of the stream (rows of a frame overlap, and the sentinel
rows of a partly empty chunk all start at 0, so L2 serves their second
reads).  Sample offsets are 64-bit, so a stream may pass 2^31 samples.
"""
from __future__ import annotations

import torch

from ..utils import cuda_build
from ..utils.config import LoraParams
from ..utils.errors import InvalidArgumentError
from ..utils.spans import count, span
from ..utils.tensors import device_table
from .chirp import downchirp_ri
from .cuda_rx import _checked

__all__ = ["extract_dechirp", "extract_dechirp_ref", "ROW_MAX"]

ROW_MAX = 2 ** 30         # the kernel indexes samples within a row in int32


def extract_dechirp_ref(ext_r, ext_i, pos, plen: int, params: LoraParams):
    """Plain PyTorch version of the extraction (any device).

    Args:
      ext_r/ext_i: float32 (len,) planes of the extended stream.
      pos: int64 (K,) row starts, each at most len - plen.
      plen: samples a row.

    Returns the dechirped rows (dr, di), each float32 (K, plen // step *
    step).
    """
    from ..models.modem import dechirp
    pkt_r = ext_r.unfold(0, plen, 1).index_select(0, pos)
    pkt_i = ext_i.unfold(0, plen, 1).index_select(0, pos)
    return dechirp(pkt_r, pkt_i, params)


def _arg(x, name: str, dtype, shape, device) -> torch.Tensor:
    try:
        return _checked(x, name, dtype, shape, device)
    except (TypeError, ValueError) as e:
        raise InvalidArgumentError(f"extract_dechirp: {e}") from e


def extract_dechirp(ext_r, ext_i, pos, plen: int, params: LoraParams):
    """Rows ``pos[k] .. pos[k] + plen`` of [tail | chunk], dechirped.

    Same contract as ``extract_dechirp_ref``.  A CPU input runs the plain
    version; a CUDA input launches ``csrc/extract_dechirp.cu`` and must be
    contiguous, with ``step | plen`` and ``plen <= ROW_MAX`` (else
    ``InvalidArgumentError``).  Reads outside the planes give zeros; the
    receivers' clamped starts never make them.
    """
    if not ext_r.is_cuda:
        return extract_dechirp_ref(ext_r, ext_i, pos, plen, params)
    with span("lora.kernel.extract_dechirp"):
        step = params.step
        if plen <= 0 or plen % step or plen > ROW_MAX:
            raise InvalidArgumentError(
                f"extract_dechirp takes a row length that is a positive "
                f"multiple of step {step}, at most {ROW_MAX}, got {plen}")
        dev = ext_r.device
        if ext_r.ndim != 1:
            raise InvalidArgumentError(
                f"extract_dechirp: ext_r must be one (len,) plane, got "
                f"shape {tuple(ext_r.shape)}")
        length = ext_r.shape[0]
        sr = _arg(ext_r, "ext_r", torch.float32, (length,), dev)
        si = _arg(ext_i, "ext_i", torch.float32, (length,), dev)
        if not isinstance(pos, torch.Tensor) or pos.ndim != 1:
            raise InvalidArgumentError(
                "extract_dechirp: pos must be an int64 (K,) tensor")
        k = pos.shape[0]
        ps = _arg(pos, "pos", torch.int64, (k,), dev)
        out_r = torch.empty((k, plen), dtype=torch.float32, device=dev)
        out_i = torch.empty((k, plen), dtype=torch.float32, device=dev)
        if k == 0:
            return out_r, out_i
        cr, ci = device_table(downchirp_ri, params.sf, params.bw_scale,
                              params.osr, device=dev)
        lib = cuda_build.load()
        with torch.cuda.device(dev):
            err = lib.lora_extract_dechirp(
                sr.data_ptr(), si.data_ptr(), length, ps.data_ptr(), k, plen,
                cr.data_ptr(), ci.data_ptr(), step, out_r.data_ptr(),
                out_i.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(
                f"lora_extract_dechirp launch failed: cudaError_t {err}")
        count("launch.extract_dechirp")
        return out_r, out_i
