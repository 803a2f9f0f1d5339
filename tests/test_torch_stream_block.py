"""The sharded stream path's local-block entry (``parallel/distributed.py::
stream_block``) and its collective spans, in a four-rank gloo run on the
CPU.

A deployment hands each rank its own time block of the capture; the
entry wraps it as the stream DTensors the receivers take, in place and
with no collective.  This file is also the worker: ``python
tests/test_torch_stream_block.py <rank> 4 <port> <dir>`` joins a gloo
group of four ranks over localhost, builds ``global_mesh(dp=1, sp=4)``
and writes what it got to ``<dir>/block_<rank>.npz``.  Each rank:

- receives a framed sf7 stream and a raw one from its own block through
  ``stream_block`` and from the whole stream through
  ``make_global_array`` (``from_global``), each once under the profiler;
- counts the collectives the entry calls (none) and checks that it made
  no copy;
- receives two frames that start in one block with one slot a rank, so
  that rank's packets outgrow its share of the slots;
- records which of the entry's argument faults raise
  ``InvalidArgumentError``: a mesh without ``sp``, planes of two lengths,
  2-D planes, planes on another device than the mesh's, and (in the
  receiver's halo gather) one rank's block shorter than the others'.

The tests hold both sharded results to the one-device call bit for bit
(the same plain versions run on every route on the CPU), and the spans
of every sharded call to the three collectives, each once inside its
stage; the one-device path opens none.  The streams are made by the port
itself from fixed seeds; the file imports neither jax nor the JAX
package.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path.insert(0, str(REPO))

import lora_sdr_lightweight_standalone_library_clean_tpu_torch as T  # noqa: E402
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.parallel import (  # noqa: E402
    distributed as D)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.utils.errors import (  # noqa: E402
    InvalidArgumentError)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.utils.spans import (  # noqa: E402
    COUNTS)

torch.set_num_threads(1)

P7 = T.LoraParams(sf=7)
LENGTH = 128 * 256          # four blocks of 8192 samples
FRAMED_AT = [700, 9000, 20000]
CLUSTER_AT = [8300, 12500]      # both in the second block
CLUSTER_KW = dict(max_packets=4)    # a share of one slot a rank
RAW_AT = [3000, 15500, 24100]
FRAME_KW = dict(max_payload_len=12, max_packets=6)
RAW_KW = dict(payload_symbols=16, max_packets=6)
FAULTS = ("no_sp_axis", "two_lengths", "two_dims", "other_device",
          "unequal_blocks")
STAGE_OF = {"halo": "lora.rx.extend", "scan": "lora.rx.scan",
            "results": "lora.rx.outputs"}
WORKER_TIMEOUT = 180


def make_stream(framed: bool, offsets=None):
    """A noisy sf7 stream with a frame (raw packet) at each offset, and
    the payloads."""
    rng = np.random.default_rng(31 if framed else 32)
    sr = torch.as_tensor(rng.standard_normal(LENGTH).astype(np.float32)
                         * 0.05)
    si = torch.as_tensor(rng.standard_normal(LENGTH).astype(np.float32)
                         * 0.05)
    offsets = offsets or (FRAMED_AT if framed else RAW_AT)
    pay = torch.as_tensor(rng.integers(0, 256, (len(offsets), 8))
                          .astype(np.uint8))
    if not framed:
        # a raw packet's last two bytes are the SX1272 CRC of bytes 2 .. 5
        crc = torch.stack([T.crc_sx1272(p[2:6]) for p in pay])
        pay[:, 6], pay[:, 7] = crc & 0xFF, crc >> 8
    syms = T.encode_frame(pay, P7) if framed else T.encode(pay)
    re, im = T.modulate(syms, P7)
    for k, g in enumerate(offsets):
        sr[g:g + re.shape[-1]] += re[k]
        si[g:g + re.shape[-1]] += im[k]
    return sr, si, pay


def receive(framed: bool, sr, si, **kw):
    if framed:
        return T.receive_stream_frames(sr, si, P7, **{**FRAME_KW, **kw})
    return T.receive_stream(sr, si, P7, **{**RAW_KW, **kw})


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------

def _spans(prof) -> list:
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith("lora.")),
                  key=lambda s: (s[1], -s[2]))


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _span_rows(prof) -> np.ndarray:
    """Each collective span: (kind, the number of spans of its stage that
    hold it)."""
    got = _spans(prof)
    rows = []
    for name, s, e in got:
        if name.startswith("lora.rx.collective."):
            kind = name.rsplit(".", 1)[1]
            holders = [o for o in got if o[0] == STAGE_OF.get(kind)
                       and _inside((name, s, e), o)]
            rows.append((list(STAGE_OF).index(kind), len(holders)))
    return np.asarray(rows).reshape(-1, 2)


def _raises(fn) -> bool:
    try:
        fn()
    except InvalidArgumentError:
        return True
    return False


def _worker(rank, world, port, out_dir) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    rank, world = int(rank), int(world)
    assert D.init_distributed(f"localhost:{port}", world, rank,
                              backend="gloo")
    mesh = D.global_mesh(dp=1, sp=world, device="cpu")
    me = mesh.get_local_rank("sp")
    res = {}
    calls = []
    for name in ("all_gather", "all_gather_into_tensor", "all_reduce",
                 "broadcast"):
        fn = getattr(dist, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)
        setattr(dist, name, counted)
    for framed in (True, False):
        tag = "f" if framed else "r"
        sr, si, _ = make_stream(framed)
        size = LENGTH // world
        mine = (sr[me * size:(me + 1) * size], si[me * size:(me + 1) * size])
        start = len(calls)
        br, bi = D.stream_block(*mine, mesh)
        res[f"{tag}_entry_collectives"] = np.asarray(len(calls) - start)
        res[f"{tag}_in_place"] = np.asarray(
            br.to_local().data_ptr() == mine[0].data_ptr()
            and bi.to_local().data_ptr() == mine[1].data_ptr())
        res[f"{tag}_global_len"] = np.asarray(br.shape[-1])
        shard = D.stream_sharding(mesh)
        whole = (D.make_global_array(sr, shard),
                 D.make_global_array(si, shard))
        for route, planes in (("block", (br, bi)), ("global", whole)):
            refits = COUNTS["rank_rows_refit"]
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                out, state = receive(framed, *planes, mesh=mesh)
            res[f"{tag}_{route}_refits"] = np.asarray(
                COUNTS["rank_rows_refit"] - refits)
            for field, value in out._asdict().items():
                res[f"{tag}_{route}_{field}"] = value.numpy()
            res[f"{tag}_{route}_tail"] = torch.stack(
                [state.tail_r, state.tail_i]).numpy()
            res[f"{tag}_{route}_spans"] = _span_rows(prof)
    # two frames in one block: that rank's packets outgrow its share
    sr, si, _ = make_stream(True, CLUSTER_AT)
    size = LENGTH // world
    refits = COUNTS["rank_rows_refit"]
    out, _ = receive(True, *D.stream_block(sr[me * size:(me + 1) * size],
                                           si[me * size:(me + 1) * size],
                                           mesh), mesh=mesh, **CLUSTER_KW)
    res["cluster_refits"] = np.asarray(COUNTS["rank_rows_refit"] - refits)
    for field, value in out._asdict().items():
        res[f"cluster_{field}"] = value.numpy()
    x = torch.zeros(LENGTH // world)
    flat = DeviceMesh("cpu", torch.arange(world), mesh_dim_names=("dp",))
    faults = {
        "no_sp_axis": lambda: D.stream_block(x, x, flat),
        "two_lengths": lambda: D.stream_block(x, x[:-32], mesh),
        "two_dims": lambda: D.stream_block(x[None], x[None], mesh),
        "other_device": lambda: D.stream_block(
            x.to("meta"), x.to("meta"), mesh),
    }
    for name, fn in faults.items():
        res[f"raises_{name}"] = np.asarray(_raises(fn))
    # the last rank's block one window of every rank shorter: the halo
    # gather finds the lengths unequal, and every rank raises
    sr, si, _ = make_stream(True)
    size = LENGTH // world
    cut = size - (128 if me == world - 1 else 0)
    short = D.stream_block(sr[me * size:me * size + cut],
                           si[me * size:me * size + cut], mesh)
    res["raises_unequal_blocks"] = np.asarray(_raises(
        lambda: receive(True, *short, mesh=mesh)))
    np.savez(Path(out_dir) / f"block_{rank}.npz", **res)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _worker(*sys.argv[1:])
    sys.exit(0)


# ---------------------------------------------------------------------------
# the tests (parent side)
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' results, in rank order."""
    out = tmp_path_factory.mktemp("block")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), str(rank), "4",
         str(port), str(out)], cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for rank in range(4)]
    try:
        for rank, proc in enumerate(procs):
            _, err = proc.communicate(timeout=WORKER_TIMEOUT)
            assert proc.returncode == 0, \
                f"rank {rank}:\n{err.decode()[-4000:]}"
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return [dict(np.load(out / f"block_{rank}.npz")) for rank in range(4)]


@pytest.mark.parametrize("framed", [True, False])
@pytest.mark.parametrize("route", ["block", "global"])
def test_sharded_routes_equal_the_one_device_call(ranks, framed, route):
    """Every rank's result through the local-block entry and through
    ``from_global`` is the one-device call's, bit for bit, and finds the
    planted packets."""
    tag = "f" if framed else "r"
    sr, si, pay = make_stream(framed)
    one, state = receive(framed, sr, si)
    for r in ranks:
        for field, value in one._asdict().items():
            np.testing.assert_array_equal(r[f"{tag}_{route}_{field}"],
                                          value.numpy(), err_msg=field)
        np.testing.assert_array_equal(
            r[f"{tag}_{route}_tail"],
            torch.stack([state.tail_r, state.tail_i]).numpy())
    valid = one.valid & one.crc_ok
    assert one.start[valid].tolist() == (FRAMED_AT if framed else RAW_AT)
    assert torch.equal(one.payload[valid][:, :8], pay)


def test_a_rank_past_its_share_of_slots_extracts_again(ranks):
    """Each rank fills ceil(K / ranks) rows; where one rank's packets
    outgrow them (two frames in one block, one row a rank), that rank
    alone extracts them again at their number, and every rank still
    returns the one-device result.  The spread streams fit their shares."""
    sr, si, pay = make_stream(True, CLUSTER_AT)
    one, _ = receive(True, sr, si, **CLUSTER_KW)
    for r in ranks:
        for field, value in one._asdict().items():
            np.testing.assert_array_equal(r[f"cluster_{field}"],
                                          value.numpy(), err_msg=field)
    valid = one.valid & one.crc_ok
    assert one.start[valid].tolist() == CLUSTER_AT
    assert torch.equal(one.payload[valid][:, :8], pay)
    assert [int(r["cluster_refits"]) for r in ranks] == [0, 1, 0, 0]
    for r in ranks:
        for key in ("f_block", "f_global", "r_block", "r_global"):
            assert int(r[f"{key}_refits"]) == 0, key


@pytest.mark.parametrize("framed", [True, False])
def test_local_block_entry_wraps_in_place_with_no_collective(ranks, framed):
    tag = "f" if framed else "r"
    for r in ranks:
        assert int(r[f"{tag}_entry_collectives"]) == 0
        assert bool(r[f"{tag}_in_place"])
        assert int(r[f"{tag}_global_len"]) == LENGTH


@pytest.mark.parametrize("fault", FAULTS)
def test_local_block_entry_raises_on_a_bad_block_or_mesh(ranks, fault):
    for r in ranks:
        assert bool(r[f"raises_{fault}"]), fault


@pytest.mark.parametrize("route", ["block", "global"])
@pytest.mark.parametrize("framed", [True, False])
def test_collective_spans_once_a_call_inside_their_stages(ranks, framed,
                                                          route):
    """A sharded call opens ``lora.rx.collective.halo``, ``.scan`` and
    ``.results`` once each, in that order, each inside one span of its
    stage (extend, scan, outputs)."""
    tag = "f" if framed else "r"
    for r in ranks:
        assert r[f"{tag}_{route}_spans"].tolist() == [[0, 1], [1, 1],
                                                      [2, 1]]


@pytest.mark.parametrize("framed", [True, False])
def test_one_device_path_opens_no_collective_span(framed):
    sr, si, _ = make_stream(framed)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        receive(framed, sr, si)
    names = [s[0] for s in _spans(prof)]
    assert names and not [n for n in names
                          if n.startswith("lora.rx.collective.")]
