"""The port's parallel layer (``parallel/mesh.py``, ``parallel/
distributed.py``, the ``mesh``/``axis`` paths of ``stream_scan``,
``receive_stream`` and ``receive_stream_frames``) in real multi-rank runs
on the CPU, against the JAX package and the port's one-device results.

This file is also the worker: ``python tests/test_torch_distributed.py
<rank> <world> <port> <run> <dir>`` joins a gloo process group of
``world`` ranks over localhost, runs ``<run>`` on CPU tensors and writes
what it got to ``<dir>/<run>_<rank>.npz``.  Two runs, started together
(tests/_mp_worker.py is the JAX package's counterpart):

 (i)  four ranks as two hosts (``LOCAL_WORLD_SIZE=2``) x dp 1 x sp 2 on
      ``global_mesh``: channel DP of a payload batch over ('host', 'dp')
      with a global exact-decode rate from ``all_reduce``, and a 16,384-
      sample sf7 stream with packets at 777 and 9003 through the
      sp-sharded ``receive_stream``;
 (ii) ``make_mesh(4, dp=1, sp=4)``: the halo case of tests/test_sharding.py
      at stride step/2, packets that straddle shard edges in blocks shorter
      than a packet, two chunks carried through the state, a two-packet
      wide sf9/BW250/osr2 stream, ``receive_stream_frames``, and the mesh
      shapes.

Both runs count the collectives the channel-DP path calls (``dist`` and
the functional collectives DTensor uses, patched in the worker): none.  The
sharded receiver calls exactly three (two all_gathers, one all_reduce).

Tolerances: starts, payloads, CRC and header verdicts, lengths and sync
words exact; CFO within 1e-5 and timing within 1e-3 samples
(tests/test_torch_stream.py); scan bins exact at symbol-aligned windows,
power within 1e-4 dB of the port's one-device scan (the same plain
version on other batch shapes) and within 0.05 dB of JAX's (summation
order of the float32 DFTs).  jax is imported inside the tests, so the
ranks start without it.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path.insert(0, str(REPO))

import lora_sdr_lightweight_standalone_library_clean_tpu_torch as T  # noqa: E402
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.parallel import (  # noqa: E402
    distributed as D, mesh as M, receiver as trx, streaming as tst)

torch.set_num_threads(1)

SF7 = dict(sf=7)
WIDE = dict(sf=9, bw=250000, cr="4/8", osr=2)
FRAMED = dict(sf=7, cr="4/6")
COLLECTIVES = ("all_gather", "all_gather_into_tensor", "all_reduce",
               "broadcast", "scatter", "reduce_scatter_tensor",
               "all_to_all_single")
FUNCOL = ("all_gather_tensor", "all_reduce", "broadcast",
          "reduce_scatter_tensor", "all_to_all_single")
WORKER_TIMEOUT = 180


# ---------------------------------------------------------------------------
# inputs: made in the parent with numpy and the port's CPU modulator, read
# by every rank (each keeps its own chunk) and by both packages
# ---------------------------------------------------------------------------

def _crc_frame(body):
    body = np.asarray(body, np.uint8)
    crc = int(T.crc_sx1272(torch.as_tensor(body[2:])))
    return np.concatenate([body, [crc & 0xFF, crc >> 8]]).astype(np.uint8)


def _plant(p, length, offsets, symbols, seed):
    """Noise (sigma 0.03) with ``symbols[k]`` modulated at ``offsets[k]``."""
    rng = np.random.default_rng(seed)
    sr = rng.standard_normal(length).astype(np.float32) * 0.03
    si = rng.standard_normal(length).astype(np.float32) * 0.03
    for g, s in zip(offsets, symbols):
        re, im = T.modulate(torch.as_tensor(s)[None], p)
        sr[g:g + re.shape[-1]] += re[0].numpy()
        si[g:g + re.shape[-1]] += im[0].numpy()
    return sr, si


def _packets(p, length, offsets, nbytes, seed):
    rng = np.random.default_rng(seed)
    pays = [_crc_frame(rng.integers(0, 256, nbytes - 2)) for _ in offsets]
    syms = [T.encode(torch.as_tensor(pl)).numpy() for pl in pays]
    return _plant(p, length, offsets, syms, seed + 1) + (np.stack(pays),)


def make_inputs() -> dict:
    p7 = T.LoraParams(**SF7)
    rng = np.random.default_rng(17)
    out = {"dp_payloads": rng.integers(0, 256, (8, 12)).astype(np.uint8)}
    # run (i): tests/_mp_worker.py's stream
    out["i_r"], out["i_i"], out["i_pay"] = _packets(p7, 16384, [777, 9003],
                                                    8, 18)
    # run (ii): the halo case of tests/test_sharding.py:49-79
    pay = np.random.default_rng(12).integers(0, 256, (4, 3)).astype(np.uint8)
    re, im = T.modulate(T.encode(torch.as_tensor(pay)), p7)
    out["halo_r"], out["halo_i"] = re.reshape(-1).numpy(), im.reshape(-1).numpy()
    # blocks of 2048 < plen 2304; each packet straddles a shard edge, and
    # ranks 0, 1 and 2 own one each, rank 3 none
    out["s_r"], out["s_i"], out["s_pay"] = _packets(
        p7, 8192, STRADDLE, 8, 20)
    pw = T.LoraParams(**WIDE)
    out["w_r"], out["w_i"], out["w_pay"] = _packets(pw, 32768, WIDE_AT, 6, 22)
    pf = T.LoraParams(**FRAMED)
    frames = [np.random.default_rng(24).integers(0, 256, n).astype(np.uint8)
              for n in FRAME_LENGTHS]
    syms = [T.encode_frame(torch.as_tensor(f)[None], pf)[0].numpy()
            for f in frames]
    out["f_r"], out["f_i"] = _plant(pf, 16384, FRAMES_AT, syms, 25)
    out["f_pay"] = np.stack([np.pad(f, (0, FRAME_MAX - f.size))
                             for f in frames])
    return out


RX_KW = dict(payload_symbols=16, max_packets=4)
WIDE_KW = dict(payload_symbols=12, max_packets=4)
FRAME_KW = dict(max_payload_len=10, max_packets=4)
STRADDLE = [1000, 3400, 5750]
WIDE_AT = [3000, 18000]
FRAMES_AT = [1000, 7000]
FRAME_LENGTHS = [3, 9]
FRAME_MAX = FRAME_KW["max_payload_len"]


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------

CALLS: list = []


def _count_collectives() -> None:
    """Record every collective call of ``torch.distributed`` and of the
    functional collectives (which DTensor's redistributions use) in
    CALLS."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol

    def counted(mod, name):
        fn = getattr(mod, name)

        def wrapped(*args, **kw):
            CALLS.append(name)
            return fn(*args, **kw)
        setattr(mod, name, wrapped)
    for name in COLLECTIVES:
        counted(dist, name)
    for name in FUNCOL:
        counted(funcol, name)


def _pipeline(payloads, p):
    """The channel-DP slice on one rank's packets."""
    syms = T.encode(payloads)
    dr, di = T.dechirp(*T.modulate(syms, p), p)
    dec, _ = T.decode(T.demodulate_tones(dr, di, p).symbols)
    return dec


def _channel_dp(mesh, sharding, payloads, p, res: dict) -> None:
    """Channel DP over ``sharding``: each rank demodulates its own packets;
    the collectives of the path (placing the batch, the pipeline, wrapping
    the result) are counted, then the global exact-decode rate comes from
    one all_reduce and the result from ``allgather``."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    start = len(CALLS)
    gpay = D.make_global_array(payloads, sharding)
    dec = _pipeline(gpay.to_local(), p)
    gdec = DTensor.from_local(dec, mesh, sharding, run_check=False)
    res["dp_collectives"] = np.asarray(len(CALLS) - start)
    exact = (dec == gpay.to_local()).all(-1).sum().to(torch.float32)
    dist.all_reduce(exact)
    replicas = dist.get_world_size() * len(dec) // len(payloads)
    res["dp_rate"] = (exact / (len(payloads) * replicas)).numpy()
    res["dp_dec"] = D.allgather(gdec)


def _packets_out(res: dict, prefix: str, pk) -> None:
    for name, value in pk._asdict().items():
        res[f"{prefix}_{name}"] = value.numpy()


def _sharded_rx(mesh, sr, si, p, res, prefix, frames=False, **kw):
    """One sharded receiver call; records its fields, state and collective
    calls."""
    gr = D.make_global_array(sr, D.stream_sharding(mesh))
    gi = D.make_global_array(si, D.stream_sharding(mesh))
    start = len(CALLS)
    fn = trx.receive_stream_frames if frames else trx.receive_stream
    pk, state = fn(gr, gi, p, mesh=mesh, **kw)
    res[f"{prefix}_calls"] = np.asarray(CALLS[start:])
    _packets_out(res, prefix, pk)
    res[f"{prefix}_tail"] = np.stack([state.tail_r.numpy(),
                                      state.tail_i.numpy()])
    return pk, state


def run_i(inp: dict, res: dict) -> None:
    import torch.distributed as dist
    mesh = D.global_mesh(dp=1, sp=2, device="cpu")
    res["shape"] = np.asarray(mesh.shape)
    nodes = [None] * dist.get_world_size()
    dist.all_gather_object(nodes, int(os.environ["GROUP_RANK"]))
    res["host_rows"] = np.asarray([[nodes[r] for r in row.flatten().tolist()]
                                   for row in mesh.mesh])
    p = T.LoraParams(**SF7)
    _channel_dp(mesh, D.channel_sharding(mesh),
                inp["dp_payloads"], p, res)
    _sharded_rx(mesh, inp["i_r"], inp["i_i"], p, res, "i",
                payload_symbols=16, max_packets=4)


def run_ii(inp: dict, res: dict) -> None:
    p7 = T.LoraParams(**SF7)
    res["shapes"] = np.asarray([M.make_mesh(4, device="cpu").shape,
                                M.make_mesh(4, dp=2, sp=2,
                                            device="cpu").shape])
    try:
        M.make_mesh(4, dp=3, sp=3, device="cpu")
        res["bad_shape_raised"] = np.asarray(False)
    except ValueError:
        res["bad_shape_raised"] = np.asarray(True)
    dp_mesh = M.make_mesh(4, device="cpu")
    _channel_dp(dp_mesh, M.packet_sharding(dp_mesh), inp["dp_payloads"], p7,
                res)
    res["shard_packets_local"] = M.shard_packets(
        inp["halo_r"], dp_mesh).to_local().numpy()
    mesh = M.make_mesh(4, dp=1, sp=4, device="cpu")
    hr = D.make_global_array(inp["halo_r"], D.stream_sharding(mesh))
    hi = D.make_global_array(inp["halo_i"], D.stream_sharding(mesh))
    scan = tst.stream_scan(hr, hi, p7, mesh, stride=p7.step // 2)
    res["halo_index"] = scan.index.full_tensor().numpy()
    res["halo_power"] = scan.power.full_tensor().numpy()
    res["halo_local"] = np.asarray(scan.index.to_local().shape)
    _sharded_rx(mesh, inp["s_r"], inp["s_i"], p7, res, "s",
                payload_symbols=16, max_packets=4)
    state = trx.stream_rx_init(p7, 16, device="cpu")
    for c in range(2):
        part = slice(4096 * c, 4096 * (c + 1))
        _, state = _sharded_rx(mesh, inp["s_r"][part], inp["s_i"][part], p7,
                               res, f"c{c}", payload_symbols=16,
                               max_packets=4, state=state)
    _sharded_rx(mesh, inp["w_r"], inp["w_i"], T.LoraParams(**WIDE), res, "w",
                payload_symbols=12, max_packets=4)
    _sharded_rx(mesh, inp["f_r"], inp["f_i"], T.LoraParams(**FRAMED), res,
                "f", frames=True, max_payload_len=FRAME_MAX, max_packets=4)


def _worker(rank, world, port, run, out_dir) -> None:
    rank, world = int(rank), int(world)
    _count_collectives()
    assert D.init_distributed(f"localhost:{port}", world, rank,
                              backend="gloo")
    inp = dict(np.load(Path(out_dir) / "inputs.npz"))
    res: dict = {}
    {"i": run_i, "ii": run_ii}[run](inp, res)
    np.savez(Path(out_dir) / f"{run}_{rank}.npz", **res)
    import torch.distributed as dist
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
def runs(tmp_path_factory):
    """Both multi-rank runs, started together: {run: [results per rank]},
    the inputs, and JAX's results on them (computed while the ranks run)."""
    out = tmp_path_factory.mktemp("dist")
    inp = make_inputs()
    np.savez(out / "inputs.npz", **inp)
    procs = []
    for run in ("i", "ii"):
        port = _free_port()
        for rank in range(4):
            env = dict(os.environ, LOCAL_WORLD_SIZE="2",
                       GROUP_RANK=str(rank // 2), LOCAL_RANK=str(rank % 2),
                       OMP_NUM_THREADS="1")
            procs.append((run, subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), str(rank),
                 "4", str(port), run, str(out)],
                cwd=REPO, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE)))
    try:
        refs = _jax_refs(inp)            # while the ranks run
        for run, proc in procs:
            _, err = proc.communicate(timeout=WORKER_TIMEOUT)
            assert proc.returncode == 0, f"run {run}:\n{err.decode()[-4000:]}"
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    got = {run: [dict(np.load(out / f"{run}_{rank}.npz"))
                 for rank in range(4)] for run in ("i", "ii")}
    return got, inp, refs


FIELDS = ("payload", "crc_ok", "valid", "start", "sync_word", "cfo",
          "time_offset", "n_candidates", "n_dropped")
FRAME_FIELDS = FIELDS + ("length", "hdr_ok", "n_err")


def _same_on_every_rank(ranks, prefix, fields):
    for f in fields + ("tail",):
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[f"{prefix}_{f}"],
                                          ranks[0][f"{prefix}_{f}"],
                                          err_msg=f)


def _assert_matches(got: dict, prefix, want, fields):
    """``got`` (a rank's npz fields) against a receiver result of either
    package: integers exact, CFO within 1e-5, timing within 1e-3."""
    for f in fields:
        g, w = got[f"{prefix}_{f}"], np.asarray(getattr(want, f))
        if f == "cfo":
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
        elif f == "time_offset":
            np.testing.assert_allclose(g, w, atol=1e-3, rtol=0)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)


def _one_device(sr, si, p, frames=False, **kw):
    fn = trx.receive_stream_frames if frames else trx.receive_stream
    return fn(torch.as_tensor(sr), torch.as_tensor(si), p, **kw)


def _jax_refs(inp: dict) -> dict:
    """JAX's one-device results on every input: the receivers jitted (one
    compile each, far quicker than op-by-op on the CPU), the scan of the
    halo case as tests/test_sharding.py runs it."""
    import functools

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import lora_sdr_lightweight_standalone_library_clean_tpu as J
    from lora_sdr_lightweight_standalone_library_clean_tpu.parallel import (
        receiver as jrx, streaming as jst)

    def rx(prefix, params, frames=False, **kw):
        fn = jrx.receive_stream_frames if frames else jrx.receive_stream
        fn = jax.jit(functools.partial(fn, params=J.LoraParams(**params),
                                       **kw))
        return fn(jnp.asarray(inp[f"{prefix}_r"]),
                  jnp.asarray(inp[f"{prefix}_i"]))[0]
    p = J.LoraParams(**SF7)
    return {"i": rx("i", SF7, **RX_KW), "s": rx("s", SF7, **RX_KW),
            "w": rx("w", WIDE, **WIDE_KW),
            "f": rx("f", FRAMED, frames=True, **FRAME_KW),
            "halo": jst.stream_scan(jnp.asarray(inp["halo_r"]),
                                    jnp.asarray(inp["halo_i"]), p,
                                    stride=p.step // 2)}


def test_channel_dp_roundtrips_with_no_collectives(runs):
    got, inp, refs = runs
    for run in ("i", "ii"):
        for r in got[run]:
            np.testing.assert_array_equal(r["dp_dec"], inp["dp_payloads"])
            assert float(r["dp_rate"]) == 1.0
            assert int(r["dp_collectives"]) == 0


def test_global_mesh_host_rows_are_the_nodes(runs):
    got, _, _ = runs
    for r in got["i"]:
        assert r["shape"].tolist() == [2, 1, 2]
        np.testing.assert_array_equal(r["host_rows"], [[0, 0], [1, 1]])


@pytest.mark.parametrize("run,prefix", [("i", "i"), ("ii", "s")])
def test_sharded_stream_matches_one_device_and_jax(runs, run, prefix):
    """Run (i)'s stream over two hosts x sp 2, and run (ii)'s packets that
    straddle shard edges in blocks shorter than a packet (one rank owns
    none): every rank returns the one-device result and JAX's."""
    got, inp, refs = runs
    ranks = got[run]
    _same_on_every_rank(ranks, prefix, FIELDS)
    sr, si = inp[f"{prefix}_r"], inp[f"{prefix}_i"]
    one, state = _one_device(sr, si, T.LoraParams(**SF7), **RX_KW)
    _assert_matches(ranks[0], prefix, one, FIELDS)
    np.testing.assert_array_equal(ranks[0][f"{prefix}_tail"][0],
                                  state.tail_r.numpy())
    _assert_matches(ranks[0], prefix, refs[prefix], FIELDS)
    offsets = [777, 9003] if run == "i" else STRADDLE
    valid = ranks[0][f"{prefix}_valid"]
    assert ranks[0][f"{prefix}_start"][valid].tolist() == offsets
    np.testing.assert_array_equal(ranks[0][f"{prefix}_payload"][valid],
                                  inp[f"{prefix}_pay"])
    assert ranks[0][f"{prefix}_crc_ok"][valid].all()


def test_sharded_receiver_makes_three_collectives(runs):
    got, _, _ = runs
    for r in got["i"] + got["ii"]:
        for prefix in ("i", "s", "c0", "c1", "w", "f"):
            if f"{prefix}_calls" in r:
                assert r[f"{prefix}_calls"].tolist() == [
                    "all_gather", "all_gather", "all_reduce"], prefix


def test_sharded_halo_scan_matches_one_device_and_jax(runs):
    """tests/test_sharding.py:49-79 over sp 4 at stride step/2: bins exact
    at symbol-aligned windows (real tones), power within 1e-4 dB of the
    port's one-device scan and 0.05 dB of JAX's."""
    got, inp, refs = runs
    p = T.LoraParams(**SF7)
    one = tst.stream_scan(torch.as_tensor(inp["halo_r"]),
                          torch.as_tensor(inp["halo_i"]), p,
                          stride=p.step // 2)
    jscan = refs["halo"]
    for r in got["ii"]:
        gi, gp = r["halo_index"], r["halo_power"]
        assert r["halo_local"].tolist() == [gi.size // 4]
        np.testing.assert_array_equal(gi[0::2], one.index.numpy()[0::2])
        np.testing.assert_array_equal(gi[0::2], np.asarray(jscan.index)[0::2])
        np.testing.assert_allclose(gp, one.power.numpy(), atol=1e-4, rtol=0)
        np.testing.assert_allclose(gp, np.asarray(jscan.power), atol=0.05,
                                   rtol=0)


def test_sharded_chunks_carry_state_like_one_device(runs):
    """Two chunks of 4096 (blocks of 1024) through the carried state: each
    chunk equals the one-device chunk, and the packets together equal the
    single call's."""
    got, inp, refs = runs
    p = T.LoraParams(**SF7)
    ranks = got["ii"]
    state = trx.stream_rx_init(p, 16, device="cpu")
    found = []
    for c in range(2):
        _same_on_every_rank(ranks, f"c{c}", FIELDS)
        part = slice(4096 * c, 4096 * (c + 1))
        one, state = _one_device(inp["s_r"][part], inp["s_i"][part], p,
                                 payload_symbols=16, max_packets=4,
                                 state=state)
        _assert_matches(ranks[0], f"c{c}", one, FIELDS)
        np.testing.assert_array_equal(ranks[0][f"c{c}_tail"][1],
                                      state.tail_i.numpy())
        v = ranks[0][f"c{c}_valid"]
        found += ranks[0][f"c{c}_start"][v].tolist()
    whole = ranks[0]["s_start"][ranks[0]["s_valid"]].tolist()
    assert sorted(found) == [g for g in whole if g + 2304 <= 8192]


def test_sharded_wide_stream_matches_one_device_and_jax(runs):
    """Two wide sf9/BW250/osr2 packets through demodulate_wide, owned by
    ranks 0 and 2 (the JAX package never shards the wide receiver)."""
    got, inp, refs = runs
    one, _ = _one_device(inp["w_r"], inp["w_i"], T.LoraParams(**WIDE),
                         **WIDE_KW)
    jres = refs["w"]
    _same_on_every_rank(got["ii"], "w", FIELDS)
    r = got["ii"][0]
    _assert_matches(r, "w", one, FIELDS)
    _assert_matches(r, "w", jres, FIELDS)
    assert r["w_start"][r["w_valid"]].tolist() == WIDE_AT
    np.testing.assert_array_equal(r["w_payload"][r["w_valid"]], inp["w_pay"])


def test_sharded_frames_match_one_device_and_jax(runs):
    got, inp, refs = runs
    one, _ = _one_device(inp["f_r"], inp["f_i"], T.LoraParams(**FRAMED),
                         frames=True, **FRAME_KW)
    jres = refs["f"]
    _same_on_every_rank(got["ii"], "f", FRAME_FIELDS)
    r = got["ii"][0]
    _assert_matches(r, "f", one, FRAME_FIELDS)
    _assert_matches(r, "f", jres, FRAME_FIELDS)
    # the planted frames pass both checks; any other candidate fails one
    v = r["f_valid"] & r["f_hdr_ok"] & r["f_crc_ok"]
    assert r["f_start"][v].tolist() == FRAMES_AT
    assert r["f_length"][v].tolist() == FRAME_LENGTHS
    np.testing.assert_array_equal(r["f_payload"][v], inp["f_pay"])


def test_mesh_shapes_and_packet_placement(runs):
    got, inp, refs = runs
    for rank, r in enumerate(got["ii"]):
        assert r["shapes"].tolist() == [[4, 1], [2, 2]]
        assert bool(r["bad_shape_raised"])
        chunk = inp["halo_r"].size // 4
        np.testing.assert_array_equal(
            r["shard_packets_local"],
            inp["halo_r"][rank * chunk:(rank + 1) * chunk])
