"""A cell of several chips: one process per rank, as ``torchrun`` starts
them, each on its own card.

``launch`` starts ``cell.chips`` ranks of this file on this machine.
Rank r gets torchrun's environment (``MASTER_ADDR`` 127.0.0.1, a free
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` r,
``LOCAL_WORLD_SIZE``), joins the program's process group through the
port's own ``init_distributed`` (NCCL on card r; gloo on the CPU in the
tests), opens a second, gloo-backed group on the CPU for the harness's
own messages, so that they never touch the communicator the program is
measured on, and runs the cell (``run.run_cell`` with that group).  A
kind of traffic that runs across ranks builds its mesh in its ``entry``
with the port's ``global_mesh``.  Rank 0 writes the merged result to a
file the launcher reads once every rank has exited 0.

No rank can hang the run: when a rank exits nonzero the launcher ends the
others, and at the deadline (``deadline_s``) it ends them all; either way
it returns None, and ``run.py`` exits nonzero with no result.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

__all__ = ["launch", "deadline_s", "SETUP_ALLOWANCE_S", "CHECK_ALLOWANCE_S"]

# The deadline, from the launcher's start: set-up, three windows, and what
# follows the window.  One chip's first set-up in a checkout (the kernels'
# nvcc build) reads up to 48.7 s, later ones 12-34 s; four ranks on H100s
# read 69.5 s at their first (each rank builds) and 27-30 s after.  The
# traced calls and the check after the window read 1-8 s.  The whole
# stays under a run's 360 s at 20 s.
SETUP_ALLOWANCE_S = 180.0
CHECK_ALLOWANCE_S = 90.0
GRACE_S = 5.0       # from SIGTERM to SIGKILL when ranks are ended
POLL_S = 0.05


def deadline_s(seconds: float) -> float:
    """Seconds from the launcher's start after which every rank is ended."""
    return SETUP_ALLOWANCE_S + 3 * seconds + CHECK_ALLOWANCE_S


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _signal(proc, sig) -> None:
    """``sig`` to the rank and whatever it started (its own session)."""
    try:
        os.killpg(proc.pid, sig)
    except ProcessLookupError:
        pass


def _end(procs: list) -> None:
    """End every rank still running, and wait for each."""
    for p in procs:
        if p.poll() is None:
            _signal(p, signal.SIGTERM)
    until = time.perf_counter() + GRACE_S
    for p in procs:
        try:
            p.wait(timeout=max(0.0, until - time.perf_counter()))
        except subprocess.TimeoutExpired:
            _signal(p, signal.SIGKILL)
            p.wait()
        _signal(p, signal.SIGKILL)     # anything the rank left behind


def _wait(procs: list, limit: float) -> str | None:
    """Wait until every rank has exited 0 (None), one exits otherwise, or
    the host clock passes ``limit``: then why."""
    while True:
        codes = [p.poll() for p in procs]
        for r, code in enumerate(codes):
            if code not in (None, 0):
                return f"rank {r} exited with {code}"
        if all(code == 0 for code in codes):
            return None
        if time.perf_counter() > limit:
            return "the deadline passed"
        time.sleep(POLL_S)


def _ended_by_signal(signum, frame):
    raise SystemExit(128 + signum)


def launch(cell, seed: int, seconds: float, traced: bool,
           backend: str = "nccl", start: float | None = None) -> dict | None:
    """Run ``cell`` on ``cell.chips`` ranks: the merged result, or None
    when a rank failed or the deadline passed (every rank ended).
    ``start``: the launcher's start on the host clock (now if None), from
    which ``setup_s`` and the deadline count."""
    start = time.perf_counter() if start is None else start
    limit = start + deadline_s(seconds)
    port = _free_port()
    before = signal.signal(signal.SIGTERM, _ended_by_signal)
    try:
        with tempfile.TemporaryDirectory(prefix="portbench-ranks-") as tmp:
            out = Path(tmp) / "result.json"
            procs = []
            try:
                for r in range(cell.chips):
                    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                               MASTER_PORT=str(port),
                               WORLD_SIZE=str(cell.chips), RANK=str(r),
                               LOCAL_RANK=str(r),
                               LOCAL_WORLD_SIZE=str(cell.chips))
                    cmd = [sys.executable, str(Path(__file__).resolve()),
                           "--root", str(cell.root), "--workload", cell.name,
                           "--seed", str(seed), "--seconds", repr(seconds),
                           "--trace", str(int(traced)),
                           "--start", repr(start), "--backend", backend,
                           "--out", str(out)]
                    # a rank's standard output goes to standard error: the
                    # launcher's standard output holds the result alone
                    procs.append(subprocess.Popen(cmd, env=env, stdout=2,
                                                  start_new_session=True))
                why = _wait(procs, limit)
            finally:
                _end(procs)
            if why is not None:
                print(f"portbench: {cell.name} across {cell.chips} ranks: "
                      f"{why}; every rank ended", file=sys.stderr)
                return None
            return json.loads(out.read_text())
    finally:
        signal.signal(signal.SIGTERM, before)


def _rank(argv=None) -> int:
    """One rank: join the groups, run the cell, and on rank 0 write the
    merged result."""
    ap = argparse.ArgumentParser()
    for flag in ("--root", "--workload", "--backend", "--out"):
        ap.add_argument(flag, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, required=True)
    ap.add_argument("--start", type=float, required=True)
    args = ap.parse_args(argv)
    import torch
    import torch.distributed as dist

    from portbench import program, run, spec
    at = [time.perf_counter()]
    torch.set_num_threads(1)
    program.join(args.backend)
    at.append(time.perf_counter())
    group = dist.new_group(backend="gloo")
    at.append(time.perf_counter())
    rank = dist.get_rank()
    device = (torch.device("cuda", torch.cuda.current_device())
              if args.backend == "nccl" else torch.device("cpu"))
    print(f"portbench: rank {rank} of {dist.get_world_size()} on {device}: "
          f"imports done {at[0] - args.start:.3f} s after the launcher's "
          f"start, the program's group joined in {at[1] - at[0]:.3f} s, the "
          f"harness's in {at[2] - at[1]:.3f} s", file=sys.stderr)
    cell = spec.load(args.workload, Path(args.root))
    result = run.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          device, start=args.start, group=group)
    found = run.forbidden_modules()
    if found:
        print(f"portbench: rank {rank} holds {', '.join(found)}",
              file=sys.stderr)
        return 3
    if rank == 0:
        Path(args.out).write_text(json.dumps(result))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    try:
        code = _rank()
    except BaseException:   # noqa: BLE001 - a rank reports and exits
        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    # no destructor may wait on a peer that is gone
    os._exit(code)
