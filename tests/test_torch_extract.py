"""The streaming receivers' packet extraction (``ops/cuda_extract.py``) on
the CPU.

On a CPU tensor ``extract_dechirp`` runs its plain version, which is the
receivers' own steps: ``unfold(...).index_select`` on each plane, then
``models/modem.py::dechirp``.  Each case holds it to those steps bit for
bit, and to a numpy emulation of the CUDA kernel's arithmetic: the
one-symbol down-chirp read at ``j % step`` (not the tiled table) and each
float32 product and sum rounded on its own.  The cases cover sf7 and sf12
at osr 1, an osr > 1 and a wide (bw_scale > 1) configuration, odd starts,
a row that ends on the last sample, repeated starts (the sentinel rows of
a partly empty chunk) and no rows at all.  Streams are made with numpy from
fixed seeds; the file imports neither jax nor the JAX package.
"""
import numpy as np
import pytest
import torch

import lora_sdr_lightweight_standalone_library_clean_tpu_torch as T
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.ops import (
    cuda_extract)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.ops.chirp import (
    downchirp_ri)

torch.set_num_threads(1)

CONFIGS = {"sf7": dict(sf=7), "sf12": dict(sf=12),
           "sf7-osr2": dict(sf=7, osr=2),
           "sf9-bw250-osr2": dict(sf=9, bw=250000, osr=2)}


def _case(p, symbols: int, starts: str, seed: int = 0):
    """A noisy (len,) stream of ``symbols + 9`` symbols, the row length of
    ``symbols`` symbols, and int64 row starts of the kind ``starts``."""
    rng = np.random.default_rng(seed)
    plen = symbols * p.step
    length = plen + 9 * p.step + 3
    sr = torch.as_tensor(rng.standard_normal(length).astype(np.float32))
    si = torch.as_tensor(rng.standard_normal(length).astype(np.float32))
    last = length - plen
    pos = {"odd": sorted(int(x) | 1 for x in rng.integers(0, last, 6)),
           "last": [0, last // 3, last],
           "repeated": [5, 5, 2 * p.step + 1, 0, 0, 0],
           "none": []}[starts]
    return sr, si, torch.as_tensor(pos, dtype=torch.int64), plen


def _kernel_arithmetic(sr, si, pos, plen, p):
    """The kernel's formula in numpy float32: x = ext[pos + j], the
    one-symbol table at j % step, every operation rounded on its own."""
    cr, ci = downchirp_ri(p.sf, p.bw_scale, p.osr)
    j = np.arange(plen)
    idx = pos.numpy()[:, None] + j[None, :]
    xr, xi = sr.numpy()[idx], si.numpy()[idx]
    c, s = cr[j % p.step], ci[j % p.step]
    return xr * c - xi * s, xr * s + xi * c


@pytest.mark.parametrize("starts", ["odd", "last", "repeated", "none"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_extract_dechirp_on_cpu_is_the_plain_steps(config, starts):
    p = T.LoraParams(**CONFIGS[config])
    sr, si, pos, plen = _case(p, 4 if p.step < 4096 else 2, starts)
    dr, di = cuda_extract.extract_dechirp(sr, si, pos, plen, p)
    want_r, want_i = T.dechirp(sr.unfold(0, plen, 1).index_select(0, pos),
                               si.unfold(0, plen, 1).index_select(0, pos), p)
    assert dr.shape == (pos.shape[0], plen)
    assert torch.equal(dr, want_r) and torch.equal(di, want_i)
    er, ei = _kernel_arithmetic(sr, si, pos, plen, p)
    assert np.array_equal(dr.numpy(), er) and np.array_equal(di.numpy(), ei)
