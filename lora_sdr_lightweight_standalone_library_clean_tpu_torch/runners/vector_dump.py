"""Golden-vector stage dumper (reference: runners/lora_phy_vector_dump.cpp).

PyTorch port of the JAX package's ``runners/vector_dump.py``: the same
flags, stage files and formats, plus ``--device {cuda,cpu}`` (default
cuda).  A deterministic (seeded) payload goes through encode -> modulate
-> demodulate -> deinterleave -> decode, and each stage is dumped under
the names the reference emits, so scripts/compare_vectors.py-style diffing
works across implementations.

On the card, ``modulate`` runs the dense TX kernel and ``demodulate`` the
fused RX kernel (``--framed``: ``dechirp -> demodulate_tones``, the same
two kernels).  The channel (``--cfo-bins``, ``--time-offset``,
``--snr-db``) runs on the planes' device; where the JAX package takes
``PRNGKey(seed)`` for the noise, the port takes a ``torch.Generator``
seeded with ``--seed``, so the CFO and the time offset are the JAX
package's and the noise is not.

Usage:
    python -m lora_sdr_lightweight_standalone_library_clean_tpu_torch.runners.vector_dump \
        --out=vecs --sf=7 --bytes=8 --seed=3 [--framed] [--device cpu]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from .. import (LoraParams, Window, dechirp, demodulate, demodulate_tones,
                encode, modulate, to_complex)
from ..models import frame
from ..ops import channel, codes
from ..utils.tensors import host_device
from . import add_device_arg


class _MT19937:
    """std::mt19937: 32-bit Mersenne Twister with C++11 scalar seeding
    (init via the 1812433253 Knuth multiplier), bit-identical to libstdc++."""

    def __init__(self, seed: int):
        self.mt = mt = [0] * 624
        mt[0] = seed & 0xFFFFFFFF
        for i in range(1, 624):
            mt[i] = (1812433253 * (mt[i - 1] ^ (mt[i - 1] >> 30)) + i) \
                & 0xFFFFFFFF
        self.idx = 624

    def _generate(self):
        mt = self.mt
        for i in range(624):
            y = (mt[i] & 0x80000000) | (mt[(i + 1) % 624] & 0x7FFFFFFF)
            mt[i] = mt[(i + 397) % 624] ^ (y >> 1) ^ (0x9908B0DF * (y & 1))
        self.idx = 0

    def __call__(self) -> int:
        if self.idx >= 624:
            self._generate()
        y = self.mt[self.idx]
        self.idx += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        return (y ^ (y >> 18)) & 0xFFFFFFFF


def _mt19937_payload(seed: int, nbytes: int) -> np.ndarray:
    """Seeded payload bit-identical to the reference's std::mt19937 +
    uniform_int_distribution<int>(0, 255) (lora_phy_vector_dump.cpp:88-92).

    libstdc++'s uniform_int_distribution for urange 256 over a 2^32-range
    generator uses the downscaling branch: scaling = (2^32-1)/256,
    reject draws >= 256*scaling, result = draw / scaling.
    """
    rng = _MT19937(seed)
    scaling = (2 ** 32 - 1) // 256
    past = 256 * scaling
    out = np.zeros(nbytes, np.uint8)
    for i in range(nbytes):
        x = rng()
        while x >= past:
            x = rng()
        out[i] = x // scaling
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="LoRa PHY stage dumper")
    ap.add_argument("--out", required=True)
    ap.add_argument("--sf", type=int, default=7)
    ap.add_argument("--bytes", type=int, default=16, dest="nbytes")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--osr", type=int, default=1)
    ap.add_argument("--bw", type=int, default=125000)
    ap.add_argument("--window", choices=["none", "hann"], default="none")
    ap.add_argument("--dump", action="append", default=None)
    ap.add_argument("--cfo-bins", type=float, default=0.0, dest="cfo_bins",
                    help="inject CFO (FFT bins) before demod "
                         "(generate_lora_phy_vectors.py:106-118)")
    ap.add_argument("--time-offset", type=int, default=0, dest="time_offset",
                    help="inject integer sample shift before demod "
                         "(generate_lora_phy_vectors.py:120-128)")
    ap.add_argument("--snr-db", type=float, default=None, dest="snr_db",
                    help="inject AWGN at this SNR (dB) before demod")
    ap.add_argument("--framed", action="store_true",
                    help="dump the full SX1272 framed chain instead "
                         "(explicit header + whitening + CR FEC + "
                         "interleaving + Gray + CRC, models/frame.py)")
    ap.add_argument("--cr", default="4/8",
                    help="coding rate for --framed (default 4/8)")
    add_device_arg(ap)
    return ap


def _channel(args, re, im, params: LoraParams):
    """The requested impairments on the planes' device; the noise comes
    from a ``torch.Generator`` there, seeded with ``--seed``."""
    if not (args.cfo_bins or args.time_offset or args.snr_db is not None):
        return re, im
    gen = torch.Generator(device=re.device).manual_seed(args.seed)
    return channel.apply_channel(
        gen, re, im, snr_db=args.snr_db, cfo_bins=args.cfo_bins or None,
        n_step=params.step, time_offset=args.time_offset or None)


def _lines(values) -> str:
    return "\n".join(str(int(v)) for v in values) + "\n"


def _iq_lines(iq) -> str:
    return "\n".join(f"{s.real:g},{s.imag:g}" for s in iq) + "\n"


def _main_framed(args, out: Path, payload: np.ndarray, dev) -> int:
    """Framed-chain dump: payload -> encode_frame -> modulate -> dechirp ->
    demodulate_tones -> decode_frame, dumping each stage.  This is the
    coded chain the reference's fixture intent describes
    (vectors/golden/golden_summary.json: "explicit header, CRC + whitening
    + interleaving enabled") but its core codec never wires."""
    params = LoraParams(sf=args.sf, bw=args.bw, cr=args.cr, osr=args.osr,
                        window=Window(args.window))
    syms = frame.encode_frame(torch.as_tensor(payload[None], device=dev),
                              params)
    re, im = _channel(args, *modulate(syms, params), params)
    iq = to_complex(re, im)[0]
    res = demodulate_tones(*dechirp(re, im, params), params)
    dec = frame.decode_frame(res.symbols[0], params)

    payload.tofile(out / "payload.bin")
    (out / "frame_symbols.csv").write_text(_lines(syms[0].cpu().numpy()))
    (out / "iq_samples.csv").write_text(_iq_lines(iq))
    (out / "demod_symbols.csv").write_text(
        _lines(res.symbols[0].cpu().numpy()))
    dec.payload.cpu().numpy().astype(np.uint8).tofile(out / "decoded.bin")
    (out / "frame_meta.csv").write_text(
        f"length,{int(dec.length)}\nhdr_ok,{int(bool(dec.hdr_ok))}\n"
        f"crc_ok,{int(bool(dec.crc_ok))}\nn_err,{int(dec.n_err)}\n")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dumps = set(args.dump or ["payload", "pre_interleave", "post_interleave",
                              "iq", "demod", "deinterleave", "decoded"])
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    dev = host_device(args.device)
    payload = _mt19937_payload(args.seed, args.nbytes)
    if args.framed:
        return _main_framed(args, out, payload, dev)

    params = LoraParams(sf=args.sf, bw=args.bw, osr=args.osr,
                        window=Window(args.window))

    # Pad codewords up to whole interleaver blocks of sf codewords
    # (lora_phy_vector_dump.cpp:95-98): cw_count = ceil(nibbles/sf)*sf,
    # symbol_count = blocks*(4+rdd).
    nibble_count = args.nbytes * 2
    cw_count = -(-nibble_count // args.sf) * args.sf
    blocks = cw_count // args.sf
    nibbles = np.zeros(nibble_count, np.uint8)
    nibbles[0::2] = payload >> 4
    nibbles[1::2] = payload & 0xF
    pre_interleave = np.zeros(cw_count, np.uint8)
    pre_interleave[:nibble_count] = codes.encode_hamming84(nibbles)

    syms = encode(torch.as_tensor(payload[None], device=dev))
    re, im = _channel(args, *modulate(syms, params), params)
    iq = to_complex(re, im)[0]
    demod = demodulate(re, im, params).symbols[0].cpu().numpy()
    rdd = 4
    # zero-pad the demod decisions to whole interleaver blocks, exactly
    # like the reference's zero-initialised demod[symbol_count] buffer
    # (lora_phy_vector_dump.cpp:109,147-153)
    symbol_count = blocks * (4 + rdd)
    demod_padded = np.zeros(symbol_count, demod.dtype)
    demod_padded[: demod.size] = demod
    deint = codes.diagonal_deinterleave(
        demod_padded.astype(np.uint16), args.sf, rdd)
    dec = codes.decode_hamming84(deint[: args.nbytes * 2])
    decoded = (((dec[0::2] & 0xF) << 4) | (dec[1::2] & 0xF)).astype(np.uint8)

    if "payload" in dumps:
        payload.tofile(out / "payload.bin")
    if "pre_interleave" in dumps:
        (out / "pre_interleave.csv").write_text(_lines(pre_interleave))
    if "post_interleave" in dumps:
        # dumped zero-padded to symbol_count like the reference's
        # post_interleave buffer (lora_phy_vector_dump.cpp:108,164-169)
        post = np.zeros(symbol_count, np.int64)
        produced = syms[0].cpu().numpy()
        post[: produced.size] = produced
        (out / "post_interleave.csv").write_text(_lines(post))
    if "iq" in dumps:
        (out / "iq_samples.csv").write_text(_iq_lines(iq))
    if "demod" in dumps:
        (out / "demod_symbols.csv").write_text(_lines(demod_padded))
    if "deinterleave" in dumps:
        (out / "deinterleave.csv").write_text(_lines(deint))
    if "decoded" in dumps:
        decoded.tofile(out / "decoded.bin")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
