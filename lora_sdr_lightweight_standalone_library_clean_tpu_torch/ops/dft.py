"""DFT over real/imaginary planes as float32 matrix products.

PyTorch port of ``lora_sdr_lightweight_standalone_library_clean_tpu/ops/
dft.py``.  The JAX package computes these DFTs with XLA outside any
kernel, so their counterparts here are plain ``torch.matmul``:

 - N <= 512: one complex product against the dense (N, N) DFT matrix
   (4 real matmuls);
 - N >= 1024: the Cooley-Tukey 4-step factorization N = N1*N2 (two small
   matmuls plus a twiddle multiply).

All twiddle/DFT matrices are host-built in float64 and used as float32.
On the card the products must run in full float32: TF32 keeps about three
decimal digits, enough to move a detection (``chip_smoke.py`` asserts
``torch.backends.cuda.matmul.allow_tf32`` is False).  Batched over
arbitrary leading axes.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.tensors import device_table

__all__ = ["dft_ri", "FACTOR_THRESHOLD", "dft_factors"]

# Above this size, use the two-stage factorized DFT.
FACTOR_THRESHOLD = 512


def dft_factors(n: int) -> tuple[int, int]:
    """Split n = n1 * n2 with factors as close to square as possible."""
    n1 = 1 << (n.bit_length() - 1) // 2
    while n1 * n1 < n:
        n1 <<= 1
    return n1, n // n1


@functools.lru_cache(maxsize=None)
def _dft_mats(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Dense DFT matrices: W[k, m] = exp(-2j*pi*k*m/n) as (cos, sin) planes."""
    k = np.arange(n, dtype=np.int64)
    # integer (k*m) % n keeps the angle argument small and exact
    ang = 2.0 * np.pi * ((k[:, None] * k[None, :]) % n) / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _twiddle(n1: int, n2: int) -> tuple[np.ndarray, np.ndarray]:
    """Twiddles T[n2_idx, k1] = exp(-2j*pi*n2_idx*k1/(n1*n2))."""
    n = n1 * n2
    idx2 = np.arange(n2, dtype=np.int64)[:, None]
    idx1 = np.arange(n1, dtype=np.int64)[None, :]
    ang = 2.0 * np.pi * ((idx2 * idx1) % n) / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _dft_direct(zr, zi, n: int):
    c, s = device_table(_dft_mats, n, device=zr.device)
    lead = zr.shape[:-1]
    # one (rows, n) x (n, n) GEMM per product: a batched matmul over the
    # leading axes runs as many matrix-vector products on the card
    zr = zr.reshape(-1, n)
    zi = zi.reshape(-1, n)
    # X = (C - iS)(zr + i zi):  Xr = zr C + zi S ; Xi = zi C - zr S
    xr = torch.matmul(zr, c) + torch.matmul(zi, s)
    xi = torch.matmul(zi, c) - torch.matmul(zr, s)
    return xr.reshape(lead + (n,)), xi.reshape(lead + (n,))


def _dft_four_step(zr, zi, n: int):
    """Cooley-Tukey: x[n1*N2 + n2] -> X[k2*N1 + k1] via two matmul stages."""
    n1, n2 = dft_factors(n)
    lead = zr.shape[:-1]
    dev = zr.device
    xr = zr.reshape(lead + (n1, n2))
    xi = zi.reshape(lead + (n1, n2))

    c1, s1 = device_table(_dft_mats, n1, device=dev)
    # Stage 1: A[n2, k1] = sum_{n1} x[n1, n2] * W1[n1, k1]
    xrt = xr.transpose(-1, -2)
    xit = xi.transpose(-1, -2)
    ar = torch.matmul(xrt, c1) + torch.matmul(xit, s1)
    ai = torch.matmul(xit, c1) - torch.matmul(xrt, s1)

    tc, ts = device_table(_twiddle, n1, n2, device=dev)
    # Twiddle: B = A * exp(-2j*pi*n2*k1/N)
    br = ar * tc + ai * ts
    bi = ai * tc - ar * ts

    c2, s2 = device_table(_dft_mats, n2, device=dev)
    # Stage 2: X[k2, k1] = sum_{n2} B[n2, k1] * W2[n2, k2]
    c2t = c2.transpose(0, 1)
    s2t = s2.transpose(0, 1)
    xr2 = torch.matmul(c2t, br) + torch.matmul(s2t, bi)
    xi2 = torch.matmul(c2t, bi) - torch.matmul(s2t, br)
    return xr2.reshape(lead + (n,)), xi2.reshape(lead + (n,))


def dft_ri(zr, zi, method: str = "auto"):
    """Forward DFT of (re, im) planes along the last axis.

    ``method``: 'auto' | 'direct' | 'factored'.
    """
    n = zr.shape[-1]
    if method == "direct" or (method == "auto" and n <= FACTOR_THRESHOLD):
        return _dft_direct(zr, zi, n)
    return _dft_four_step(zr, zi, n)
