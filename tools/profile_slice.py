#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's packet slice, on one CUDA card.

Run from the root of a checkout:

    python3 tools/profile_slice.py [--sf 7] [--bw 125000] [--osr 1]
                                   [--packets 8192] [--iters 5] [--out PATH]
                                   [--stream] [--framed] [--sass]

It runs ``encode -> modulate_dechirped -> demodulate_tones -> decode`` at
the given sf, bandwidth and oversampling, CR4-5, on random 32-byte payloads
(by default the sf7 batch of ``chip_smoke.py`` phase 4; ``--sf 12 --packets
256`` is its phase 5, ``--sf 7 --osr 2 --packets 4096`` its decimated osr-2
slice).  At BW250/500 with osr >= bw_scale the receiver is the injective
``demodulate_wide`` instead (``--sf 12 --bw 500000 --osr 4 --packets 64``
and ``--sf 9 --bw 250000 --osr 2 --packets 1024`` are ``chip_smoke.py``'s
wide slices).  With ``--stream`` it profiles the streaming receiver
instead: ``chip_smoke.py``'s stream slice of that many packets (one
continuous stream, ``receive_stream`` in one call; ``--stream --packets
8192`` is S7, ``--stream --sf 12 --packets 256`` S12, ``--stream --sf 9
--bw 250000 --osr 2 --packets 1024`` SW).  With
``--framed`` the packets are SX1272 frames: the slice is ``encode_frame ->
modulate_dechirped -> demodulate_tones -> decode_frame_padded`` on 32-byte
frames (``--framed --packets 8192`` is ``chip_smoke.py``'s sf7 framed
slice), and ``--stream --framed`` profiles ``receive_stream_frames`` on
``chip_smoke.py``'s framed stream of that many frames of lengths 1-32
(``--stream --framed --packets 8192 --power-gate-db 4`` is F7), with
``max_packets`` twice the frame count as there.  It reports, all from one
process:

- wall ms per iteration: CUDA events over ``--iters`` iterations after a
  warm-up, without the profiler;
- device busy ms per iteration: the summed duration of the device
  activities (kernels, copies, fills) that ``torch.profiler`` records over
  ``--iters`` further iterations, with their launches per iteration, by
  name;
- the device's idle share, 1 - busy / wall, with the wall of the
  unprofiled run;
- the stages: one more iteration under the profiler, read by the
  program's own spans (``lora.*``, ``utils/spans.py``) as
  ``portbench/metrics/_stages.py`` reads them: each span's host self ms,
  the device ms of what it launched (itself and nested), the device-idle
  ms while it was the innermost span, and the host's waits on the device;
- the SM clock (``nvidia-smi``) right after the timed iterations;
- with ``--sass``, the static SASS instruction count (``cuobjdump -sass``
  on the built kernel library) of each RX kernel instance the slice
  launched: straight-line code for the ``StreamReader`` instances, an
  upper bound where the accurate sincosf has a slow path.

The report starts with the ``nvidia-smi`` name/power-limit line, is
printed, and is written to ``--out`` (default
``build/profile_sf<sf>_bw<kHz>_osr<osr>.txt``, ``profile_stream_...`` with
``--stream``).  It exits nonzero without a CUDA card or when the profiler
records no device activity.
"""
from __future__ import annotations

import argparse
import collections
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import lora_sdr_lightweight_standalone_library_clean_tpu_torch as lora  # noqa: E402
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.utils import (  # noqa: E402
    cuda_build)
from portbench.metrics import _stages  # noqa: E402

PAYLOAD = 32


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _sm_clock() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _rx_label(name: str):
    """``rx_dense_kernel<128, StreamReader>`` from a profiler or mangled
    kernel name, or None for other kernels."""
    m = re.search(r"(rx_[a-z]+_kernel)<(\d+), lora_rx::(\w+)>", name)
    if m:
        return f"{m.group(1)}<{m.group(2)}, {m.group(3)}>"
    from chip_smoke import _kernel_label
    label = _kernel_label(name)
    return label if label.startswith("rx_") else None


def _sass_counts() -> dict:
    """{RX kernel instance: static SASS instructions, NOPs left out} of
    the kernel library ``cuda_build.load()`` built."""
    lib = cuda_build.BUILD_INFO["path"]
    tool = Path(cuda_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", lib], capture_output=True,
                         text=True, timeout=600, check=True).stdout
    counts = {}
    for part in re.split(r"\n\s*Function : ", out)[1:]:
        label = _rx_label(part.split("\n", 1)[0].strip())
        if label:
            counts[label] = sum(
                1 for op in re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", part)
                if not op.strip().startswith("NOP"))
    return counts


def _wide(p) -> bool:
    """BW250/500 with osr >= bw_scale: the receiver that keeps every
    symbol bit is ``demodulate_wide``."""
    return p.bw_scale > 1 and p.osr >= p.bw_scale


def _slice(payload, p, framed: bool):
    """The slice as one function of no arguments, and the dict it leaves
    its outputs in."""
    state = {}
    demod = lora.demodulate_wide if _wide(p) else lora.demodulate_tones

    def run():
        syms = (lora.encode_frame(payload, p) if framed
                else lora.encode(payload))
        state["res"] = demod(*lora.modulate_dechirped(syms, p), p)
        if framed:
            fr = lora.decode_frame_padded(state["res"].symbols, p, PAYLOAD)
            state["dec"], state["ok"] = fr.payload, fr.crc_ok
        else:
            state["dec"], state["ok"] = lora.decode(state["res"].symbols)
    return state, run, demod.__name__


def _stream_call(sr, si, p, count, gate, framed: bool):
    """One ``receive_stream`` (``receive_stream_frames``) call over the
    whole stream, no carried state, as a function of no arguments, and
    the dict it leaves its outputs in."""
    state = {}

    def run():
        if framed:
            state["out"], _ = lora.receive_stream_frames(
                sr, si, p, max_payload_len=PAYLOAD, max_packets=2 * count,
                power_gate_db=gate)
        else:
            state["out"], _ = lora.receive_stream(
                sr, si, p, payload_symbols=2 * PAYLOAD, max_packets=count,
                power_gate_db=gate)
    return state, run


def _wall_ms(run, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        run()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _device_activity(run, iters: int):
    """{name: [launches, total us]} of the device activities in ``iters``
    runs, from torch.profiler."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
    acts = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            acts[e.name][0] += 1
            acts[e.name][1] += e.time_range.elapsed_us()
    return acts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=int, default=7)
    ap.add_argument("--bw", type=int, default=125000)
    ap.add_argument("--osr", type=int, default=1)
    ap.add_argument("--packets", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=None)
    ap.add_argument("--stream", action="store_true",
                    help="profile receive_stream on chip_smoke.py's stream "
                         "slice of --packets packets")
    ap.add_argument("--framed", action="store_true",
                    help="SX1272 frames: encode_frame/decode_frame_padded, "
                         "or with --stream receive_stream_frames on "
                         "chip_smoke.py's framed stream")
    ap.add_argument("--power-gate-db", type=float, default=5.0,
                    help="receive_stream's sync gate (chip_smoke.py's S7 "
                         "and S12 pass 4)")
    ap.add_argument("--sass", action="store_true",
                    help="report the static SASS instruction count of the "
                         "RX kernel instances the slice launched")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_slice: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    p = lora.LoraParams(sf=args.sf, bw=args.bw, osr=args.osr, cr="4/5")
    rng = np.random.default_rng(args.seed)
    if args.stream:
        from chip_smoke import _frame_stream, _stream_slice
        if args.framed:
            sr, si, payload, lengths, planted = _frame_stream(
                p, args.packets, rng, dev)
        else:
            sr, si, payload, _, planted = _stream_slice(p, args.packets,
                                                        rng, dev)
        state, run = _stream_call(sr, si, p, args.packets,
                                  args.power_gate_db, args.framed)
        what = (f"receive_stream{'_frames' if args.framed else ''} on one "
                f"stream of {sr.shape[-1]:,} samples ({args.packets} "
                f"{'frames' if args.framed else 'packets'}, gate "
                f"{args.power_gate_db} dB)")
    else:
        payload = torch.as_tensor(
            rng.integers(0, 256, (args.packets, PAYLOAD)).astype(np.uint8),
            device=dev)
        state, run, demod = _slice(payload, p, args.framed)
        what = (f"{demod}, {args.packets} "
                f"{'frames' if args.framed else 'packets'} x {PAYLOAD} B")

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    if args.stream and args.framed:
        fr = state["out"]
        at = fr.start[fr.valid]
        rows = torch.searchsorted(at, planted)
        assert torch.equal(at[rows], planted), "starts"
        assert torch.equal(fr.payload[fr.valid][rows], payload), \
            "the stream did not decode"
    elif args.stream:
        pk = state["out"]
        assert bool(pk.valid.all()), "the stream lost packets"
        assert torch.equal(pk.start, planted), "starts"
        assert torch.equal(pk.payload, payload), "the stream did not decode"
    elif p.osr == 1 or _wide(p):
        assert torch.equal(state["dec"], payload), "the slice did not decode"
    else:
        # the decimated receiver reads the last symbol's edge row at
        # phase 0 (the reference's clamp), so only the others are exact
        want = lora.encode(payload) * p.bw_scale % p.n
        assert torch.equal(state["res"].symbols[:, :-1], want[:, :-1]), \
            "the slice did not demodulate"

    wall = _wall_ms(run, args.iters)
    clock = _sm_clock()
    acts = _device_activity(run, args.iters)
    if not acts:
        print("profile_slice: the profiler recorded no device activity",
              file=sys.stderr)
        return 1
    busy = sum(us for _, us in acts.values()) / 1e3 / args.iters
    launches = sum(c for c, _ in acts.values()) / args.iters

    window = _stages.record(run, 1, torch.cuda.synchronize)

    lines = [
        _smi(),
        f"torch {torch.__version__} cuda {torch.version.cuda}; sf{args.sf} "
        f"BW{args.bw // 1000} osr{args.osr} through {what}, "
        f"{args.iters} iterations",
        f"wall per iteration {wall:.3f} ms (CUDA events, no profiler); "
        f"device busy {busy:.3f} ms per iteration ({launches:.0f} device "
        f"activities); idle share {1.0 - busy / wall:.3f}",
        f"SM clock right after the timed iterations, and its maximum: "
        f"{clock}",
        "device time per iteration, by activity:",
    ]
    for name, (count, us) in sorted(acts.items(), key=lambda kv: -kv[1][1]):
        lines.append(f"  {us / args.iters:9.1f} us  {count / args.iters:4.0f}x"
                     f"  {name[:110]}")
    lines.append("the program's stages over one more iteration:")
    lines.append(_stages.table(_stages.analyse(window), window))
    if args.sass:
        counts = _sass_counts()
        lines.append("static SASS instructions a thread of each RX kernel "
                     "instance launched:")
        for label in sorted({_rx_label(n) for n in acts} - {None}):
            lines.append(f"  {label}: {counts[label]}")
    report = "\n".join(lines)
    print(report)
    kind = ("stream_" if args.stream else "") + \
        ("framed_" if args.framed else "")
    out = Path(args.out or f"build/profile_{kind}sf{args.sf}_bw"
               f"{args.bw // 1000}_osr{args.osr}.txt")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(report + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
