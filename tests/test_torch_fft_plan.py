"""The RX kernels' FFT plan (``ops/cuda_rx.py::_fft_plan``), on the CPU.

The CUDA kernels ``csrc/rx_dense.cu`` (n <= 512) and ``csrc/rx_hybrid.cu``
(n = 1024 ... 16384) run an in-place mixed-radix DIF FFT whose radices,
twiddle table and natural-bin map come from ``_fft_plan``
(``csrc/rx_fft.cuh``).  The kernels themselves run only on a card
(``tests/test_torch_cuda.py``); here a numpy emulation of their pass
structure, in float32 with the kernels' own order of operations, runs on
the plan's exact tables:

- rx_hybrid: thread t loads samples t + q*n/16, each pass runs its r-point
  DFTs in registers (radix-2 DIF stages with the W_16 constants), multiplies
  by the table's twiddles and stores to the padded shared plane (word a at
  a + a/16), and the next pass loads from it;
- rx_dense: lane t loads samples t + q*T (T = n/16 lanes per window), one
  in-register pass, then radix-2 passes in which lane t pairs with lane
  t ^ h by a shuffle.

The emulated spectrum, read through ``bins``, is held against
``np.fft.fft`` (relative error within 1e-5: float32 arithmetic against
float64), and the shared-memory exchanges of rx_hybrid are checked to be
free of bank conflicts.
"""
import re
from pathlib import Path

import numpy as np
import pytest

from lora_sdr_lightweight_standalone_library_clean_tpu_torch.ops import cuda_rx

SIZES = [1 << k for k in range(2, 15)]          # 4 ... 16384
HYBRID = [n for n in SIZES if n > cuda_rx.RX_DENSE_MAX_N]
CSRC = Path(cuda_rx.__file__).resolve().parent.parent / "csrc"
F32 = np.float32


def _cmul(ar, ai, wr, wi):
    """(a * w) in float32, one rounding per product and per sum."""
    return F32(ar * wr) - F32(ai * wi), F32(ar * wi) + F32(ai * wr)


def _dft_regs(vr, vi, r):
    """The kernels' in-register r-point DFT along the last axis (radix-2
    DIF stages, twiddles W_16^(m*8/h)); column j ends holding output
    brev(j)."""
    vr, vi = vr.copy(), vi.copy()
    h = r // 2
    while h >= 1:
        for j in range(r // 2):
            lo = (j // h) * 2 * h + j % h
            hi = lo + h
            ar, ai, br, bi = (a[..., k].copy() for a, k in
                              ((vr, lo), (vi, lo), (vr, hi), (vi, hi)))
            vr[..., lo], vi[..., lo] = ar + br, ai + bi
            w = cuda_rx._W16[(j % h) * (8 // h)]
            vr[..., hi], vi[..., hi] = _cmul(ar - br, ai - bi, w[0], w[1])
        h //= 2
    return vr, vi


def _padded(a):
    return a + (a >> 4)


def _hybrid_accesses(plan, n):
    """(pass, butterfly group, q, padded word per thread) of every shared
    access of rx_hybrid: a pass loads (from pass 1 on) and stores (to the
    last but one) the same words."""
    t = np.arange(plan.threads)
    out, span = [], n
    for p, r in enumerate(plan.radices):
        lq = span // r
        for g in range(cuda_rx.RX_VALUES // r):
            b = t + g * plan.threads
            base = (b // lq) * span + b % lq
            for q in range(r):
                out.append((p, g, q, _padded(base + q * lq)))
        span = lq
    return out


def _emulate(plan, n, xr, xi):
    """The kernel's registers at the end of the FFT: (threads, values)
    float32 planes, register v of thread t in [t, v]."""
    T, V = plan.threads, n // plan.threads
    t = np.arange(T)
    idx = t[:, None] + np.arange(V)[None, :] * T
    rr, ri = xr[idx].copy(), xi[idx].copy()
    tw = plan.tw
    P = len(plan.radices)
    if plan.warp:
        rr, ri = _dft_regs(rr, ri, V)
        if P > 1:
            for j in range(1, V):
                s = cuda_rx._brev(j, V)
                w = tw[(s - 1) * T + t]
                rr[:, j], ri[:, j] = _cmul(rr[:, j], ri[:, j], w[:, 0], w[:, 1])
        table = (V - 1) * T
        for p in range(1, P):
            h = T >> p
            upper = (t & h) != 0
            pr, pi = rr[t ^ h], ri[t ^ h]
            nr = np.where(upper[:, None], pr - rr, rr + pr)
            ni = np.where(upper[:, None], pi - ri, ri + pi)
            if p < P - 1:
                w = np.where(upper[:, None], tw[table + (t & (h - 1))],
                             np.array([1.0, 0.0], F32))
                nr, ni = _cmul(nr, ni, w[:, :1], w[:, 1:])
                table += h
            rr, ri = nr.astype(F32), ni.astype(F32)
        return rr, ri
    sh_r = np.zeros(_padded(n), F32)
    sh_i = np.zeros(_padded(n), F32)
    span, table = n, 0
    for p, r in enumerate(plan.radices):
        lq = span // r
        for g in range(V // r):
            cols = slice(g * r, g * r + r)
            b = t + g * T
            m = b % lq
            base = (b // lq) * span + m
            addr = _padded(base[:, None] + np.arange(r)[None, :] * lq)
            if p > 0:
                rr[:, cols], ri[:, cols] = sh_r[addr], sh_i[addr]
            rr[:, cols], ri[:, cols] = _dft_regs(rr[:, cols], ri[:, cols], r)
            if p < len(plan.radices) - 1:
                for j in range(r):
                    s = cuda_rx._brev(j, r)
                    c = g * r + j
                    if s > 0:
                        w = tw[table + (s - 1) * lq + m]
                        rr[:, c], ri[:, c] = _cmul(rr[:, c], ri[:, c],
                                                   w[:, 0], w[:, 1])
                    a = _padded(base + s * lq)
                    sh_r[a], sh_i[a] = rr[:, c], ri[:, c]
        table += (r - 1) * lq
        span = lq
    return rr, ri


def _spectrum(plan, n, xr, xi):
    """The emulated FFT in natural order, through the plan's bin map."""
    rr, ri = _emulate(plan, n, xr, xi)
    out = np.empty(n, np.complex128)
    bins = plan.bins.reshape(n // plan.threads, plan.threads)     # [v, t]
    out[bins.T.reshape(-1)] = (rr + 1j * ri.astype(np.float64)).reshape(-1)
    return out


@pytest.mark.parametrize("n", SIZES)
def test_fft_plan_emulation_matches_numpy_fft(n):
    """The kernels' pass structure on the plan's exact float32 tables gives
    np.fft.fft of random float32 input within 1e-5 relative error."""
    plan = cuda_rx._fft_plan(n)
    assert int(np.prod(plan.radices)) == n
    assert plan.tw.dtype == np.float32 and plan.tw.shape[1] == 2
    rng = np.random.default_rng(n)
    xr = rng.standard_normal(n).astype(F32)
    xi = rng.standard_normal(n).astype(F32)
    want = np.fft.fft(xr.astype(np.float64) + 1j * xi.astype(np.float64))
    got = _spectrum(plan, n, xr, xi)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 1e-5, err


@pytest.mark.parametrize("n", SIZES)
def test_fft_plan_bins_put_the_output_in_natural_order(n):
    """``bins`` is a permutation of 0 ... n-1, and a pure tone at bin k ends
    in the one register whose bin is k (k = 0, 1, n/2 - 1, n/2, n - 1);
    an impulse at sample 0 gives 1 in every register exactly."""
    plan = cuda_rx._fft_plan(n)
    assert plan.bins.dtype == np.int32
    assert np.array_equal(np.sort(plan.bins), np.arange(n))
    i = np.arange(n)
    for k in sorted({0, 1, n // 2 - 1, n // 2, n - 1}):
        x = np.exp(2j * np.pi * k * i / n)
        rr, ri = _emulate(plan, n, x.real.astype(F32), x.imag.astype(F32))
        mag = (rr * rr + ri * ri).T.reshape(-1)                  # [v, t]
        assert plan.bins[int(np.argmax(mag))] == k
        assert np.abs(_spectrum(plan, n, x.real.astype(F32),
                                x.imag.astype(F32))[k] - n) <= 1e-4 * n
    imp = np.zeros(n, F32)
    imp[0] = 1.0
    rr, ri = _emulate(plan, n, imp, np.zeros(n, F32))
    assert np.array_equal(rr, np.ones_like(rr))
    assert np.array_equal(ri, np.zeros_like(ri))


@pytest.mark.parametrize("n", HYBRID)
def test_hybrid_exchanges_are_bank_conflict_free(n):
    """rx_hybrid: at most 3 shared-memory exchanges (2 at 1024 ... 4096),
    and in each of their loads and stores the 16 lanes of every half-warp
    touch 16 distinct bank pairs of the padded float2 plane."""
    plan = cuda_rx._fft_plan(n)
    exchanges = len(plan.radices) - 1
    assert exchanges <= (2 if n <= 4096 else 3)
    for p, g, q, words in _hybrid_accesses(plan, n):
        for h in range(0, plan.threads, 16):
            banks = words[h:h + 16] % 16
            assert len(set(banks.tolist())) == 16, (p, g, q, h)


def test_w16_constants_in_the_source_are_the_plan_s():
    """The in-register DFT constants of csrc/rx_fft.cuh are ``_W16``: the
    float32 roundings of exp(-2j*pi*k/16), with 1 and -j exact."""
    src = (CSRC / "rx_fft.cuh").read_text()
    for part, col in (("re", 0), ("im", 1)):
        body = re.search(r"constexpr float w16_%s\(int k\) \{(.*?)\n\}" % part,
                         src, re.S).group(1)
        lits = [F32(v) for v in re.findall(r"(-?\d+\.\d+)f", body)]
        assert np.array_equal(np.array(lits, F32), cuda_rx._W16[:, col])
