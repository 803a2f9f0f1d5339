"""The port's stage spans and its one counter registry (``utils/spans.py``),
on the CPU.

Under ``torch.profiler.profile(activities=[CPU])`` the streaming receivers
show their root span once a call with each stage span once inside it, in
order, and the packet pipeline ``encode -> modulate_dechirped ->
demodulate_tones -> decode`` shows its spans; with no profiler a span is
the shared no-op and no ``record_function`` is made.  ``COUNTS`` holds the
launches of the hand-written kernels (none on the CPU, where every route
runs its plain version) and the bytes of the sharded receiver's
collectives, checked here on a one-rank gloo mesh.  On a card (marked
``cuda``, skipped here) the extraction kernel's span opens inside
``lora.rx.extract`` and the framed decoder kernel's inside
``lora.codec.decode_frame``, once a stream call.  Streams are made by the port
itself from fixed seeds; the file imports neither jax nor the JAX
package.
"""
import contextlib
import inspect
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

import lora_sdr_lightweight_standalone_library_clean_tpu_torch as T
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.models import (
    tones)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.ops import (
    cuda_detect, cuda_extract, cuda_frame, cuda_rx, cuda_stream, cuda_tx)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.parallel import (
    distributed as D, mesh as M, receiver)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.utils import (
    spans)

torch.set_num_threads(1)

P7 = T.LoraParams(sf=7)
PAYLOAD = 8
STAGES = ("lora.rx.extend", "lora.rx.scan", "lora.rx.select",
          "lora.rx.extract", "lora.rx.demod", "lora.rx.norm",
          "lora.rx.estimate", "lora.rx.detect")


def _spans(prof) -> list:
    """(name, start us, end us) of the ``lora.`` spans, in start order."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith("lora.")),
                  key=lambda s: (s[1], -s[2]))


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _stream(framed: bool, offsets=(1000, 12000), length=128 * 200,
            seed=1):
    """A noisy sf7 stream with a packet (frame) at each offset, and the
    payloads."""
    rng = np.random.default_rng(seed)
    sr = torch.as_tensor(rng.standard_normal(length).astype(np.float32)
                         * 0.05)
    si = torch.as_tensor(rng.standard_normal(length).astype(np.float32)
                         * 0.05)
    pay = torch.as_tensor(rng.integers(0, 256, (len(offsets), PAYLOAD))
                          .astype(np.uint8))
    syms = T.encode_frame(pay, P7) if framed else T.encode(pay)
    re, im = T.modulate(syms, P7)
    n = re.shape[-1]
    for k, g in enumerate(offsets):
        sr[g:g + n] += re[k]
        si[g:g + n] += im[k]
    return sr, si, pay


def _receive(framed: bool, sr, si, state=None):
    if framed:
        return T.receive_stream_frames(sr, si, P7, max_payload_len=PAYLOAD,
                                       max_packets=4, state=state)
    return T.receive_stream(sr, si, P7, payload_symbols=2 * PAYLOAD,
                            max_packets=4, state=state)


@pytest.mark.parametrize("framed", [False, True])
def test_stream_receivers_nest_their_stages_in_one_root(framed):
    """Two chunks of one stream: the root once a call, each stage once
    inside it and in the receiver's order, the demodulator's three stages
    inside ``lora.rx.demod``, the decoder's span after it, then the
    outputs; every span of the call lies in its root."""
    sr, si, pay = _stream(framed)
    half = sr.shape[-1] // 2
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out, state = _receive(framed, sr[:half], si[:half])
        out2, _ = _receive(framed, sr[half:], si[half:], state)
    assert torch.equal(out.payload[:1], pay[:1])
    assert torch.equal(out2.payload[:1], pay[1:])
    root = "lora.receive_stream_frames" if framed else "lora.receive_stream"
    codec = "lora.codec.decode_frame" if framed else "lora.codec.decode"
    got = _spans(prof)
    roots = [s for s in got if s[0] == root]
    assert len(roots) == 2
    for r in roots:
        inner = [s for s in got if s is not r and _inside(s, r)]
        names = [s[0] for s in inner]
        assert names == list(STAGES) + [codec, "lora.rx.outputs"], names
        demod = inner[STAGES.index("lora.rx.demod")]
        for stage in ("lora.rx.norm", "lora.rx.estimate", "lora.rx.detect"):
            assert _inside(inner[names.index(stage)], demod), stage
        for a, b in zip(inner, inner[1:]):
            if not _inside(b, a):
                assert a[2] <= b[1], (a, b)
    assert len(got) == 2 * (len(STAGES) + 3)


def test_packet_pipeline_shows_its_spans():
    """``encode -> modulate_dechirped -> demodulate_tones -> decode``: four
    roots, the demodulator's stages inside its root, nothing else."""
    pay = torch.as_tensor(np.random.default_rng(3).integers(
        0, 256, (4, PAYLOAD)).astype(np.uint8))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        dr, di = T.modulate_dechirped(T.encode(pay), P7)
        res = T.demodulate_tones(dr, di, P7)
        got_pay, _ = T.decode(res.symbols)
    assert torch.equal(got_pay, pay)
    got = _spans(prof)
    assert [s[0] for s in got] == [
        "lora.codec.encode", "lora.tx.modulate", "lora.rx.demod",
        "lora.rx.norm", "lora.rx.estimate", "lora.rx.detect",
        "lora.codec.decode"]
    for s in got[3:6]:
        assert _inside(s, got[2])


@pytest.mark.parametrize("demod", ["demodulate", "demodulate_wide"])
def test_other_demodulators_show_their_stages(demod):
    """The full RX (estimate, detect) and the wide receiver (norm,
    estimate, detect) inside ``lora.rx.demod``."""
    p = (T.LoraParams(sf=7) if demod == "demodulate"
         else T.LoraParams(sf=7, bw=250000, osr=2))
    re, im = T.modulate(torch.zeros(2, 4, dtype=torch.int32), p)
    if demod == "demodulate_wide":
        re, im = T.dechirp(re, im, p)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        getattr(T, demod)(re, im, p)
    names = [s[0] for s in _spans(prof)]
    stages = ["lora.rx.estimate", "lora.rx.detect"]
    if demod == "demodulate_wide":
        stages = ["lora.rx.norm"] + stages
    assert names == ["lora.rx.demod"] + stages


def test_frame_codec_spans():
    pay = torch.as_tensor(np.arange(PAYLOAD, dtype=np.uint8))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        syms = T.encode_frame(pay[None], P7)
        res = T.decode_frame(syms[0], P7)
    assert torch.equal(res.payload, pay)
    names = [s[0] for s in _spans(prof)]
    # decode_frame sizes the padded decoder to the header: one span in
    # the other
    assert names == ["lora.codec.encode_frame", "lora.codec.decode_frame",
                     "lora.codec.decode_frame"]


def test_no_profiler_no_record_function(monkeypatch):
    """With no profiler session ``span`` is one shared no-op and no entry
    point makes a ``RecordFunction``."""
    a, b = spans.span("lora.a"), spans.span("lora.b")
    assert a is b and isinstance(a, contextlib.nullcontext)

    def refuse(name, *args, **kw):
        raise AssertionError(f"RecordFunction {name!r} with no profiler")
    monkeypatch.setattr(spans, "_record", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    sr, si, pay = _stream(True)
    out, _ = _receive(True, sr, si)
    assert torch.equal(out.payload[:2], pay)
    dr, di = T.modulate_dechirped(T.encode(pay), P7)
    got, _ = T.decode(T.demodulate_tones(dr, di, P7).symbols)
    assert torch.equal(got, pay)


def test_spanned_entry_points_keep_their_signatures():
    for fn in (T.receive_stream, T.receive_stream_frames, T.encode,
               T.decode, T.modulate, T.modulate_dechirped, T.demodulate,
               T.demodulate_wide, T.demodulate_tones, T.encode_frame,
               T.decode_frame, T.decode_frame_padded):
        assert inspect.signature(fn) == inspect.signature(fn.__wrapped__)
        assert fn.__doc__ == fn.__wrapped__.__doc__


def _route_calls():
    """Every route to a hand-written kernel, called with CPU tensors."""
    p2 = T.LoraParams(sf=7, osr=2)
    p12 = T.LoraParams(sf=12)
    syms = torch.zeros(1, 4, dtype=torch.int32)
    z = torch.zeros(1, 4 * P7.step)
    zw = torch.zeros(1, 4 * 2 * 128)
    pw = T.LoraParams(sf=7, bw=250000, osr=2)
    z12 = torch.zeros(1, 4 * p12.step)
    return {
        "tx_dense": lambda: T.modulate_dechirped(syms, P7),
        "tx_factored": lambda: T.modulate_dechirped(syms, p12),
        "tx_osr": lambda: T.modulate(syms, p2),
        "rx_dense": lambda: T.demodulate_tones(z, z, P7),
        "rx_hybrid": lambda: T.demodulate_tones(z12, z12, p12),
        "rx_osr": lambda: T.demodulate(*T.modulate(syms, p2), p2),
        "stream_scan": lambda: T.streaming.stream_scan(
            torch.zeros(8 * P7.step), torch.zeros(8 * P7.step), P7),
        "rotate_detect": lambda: T.demodulate_tones(z, z, P7,
                                                    backend="pallas"),
        "wide": lambda: T.demodulate_wide(zw, zw, pw),
        "extract_dechirp": lambda: cuda_extract.extract_dechirp(
            torch.zeros(8 * P7.step), torch.zeros(8 * P7.step),
            torch.tensor([0, 3]), 4 * P7.step, P7),
        "decode_frame": lambda: T.decode_frame_padded(
            torch.zeros(2, T.max_frame_symbols(P7, 4), dtype=torch.int32),
            P7, 4),
    }


@pytest.mark.parametrize("route", sorted(_route_calls()))
def test_plain_routes_launch_nothing(route):
    """On the CPU each route runs its kernel's plain version: no
    ``launch.*`` counter moves and no ``lora.kernel.*`` span opens."""
    before = dict(spans.COUNTS)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _route_calls()[route]()
    assert dict(spans.COUNTS) == before
    names = {s[0] for s in _spans(prof)}
    assert not {n for n in names if n.startswith("lora.kernel.")}


def test_launch_paths_count_in_the_registry():
    """The one registry: no kernel wrapper keeps a counter of its own, and
    ``count`` adds to ``COUNTS``."""
    for mod in (cuda_tx, cuda_rx, cuda_stream, cuda_detect, cuda_extract,
                cuda_frame, tones):
        assert not [n for n in vars(mod) if n.endswith("LAUNCHES")], mod
    assert not hasattr(T.streaming, "COLLECTIVE_BYTES")
    before = spans.COUNTS["launch.test_only"]
    spans.count("launch.test_only")
    spans.count("launch.test_only", 2)
    assert spans.COUNTS["launch.test_only"] == before + 3
    del spans.COUNTS["launch.test_only"]


@pytest.mark.cuda
@pytest.mark.parametrize("framed", [False, True])
def test_extraction_kernel_opens_inside_extract_on_card(framed):
    """On the card each stream call launches the extraction kernel once:
    one ``lora.kernel.extract_dechirp`` span inside each
    ``lora.rx.extract``, and ``COUNTS["launch.extract_dechirp"]`` one
    higher a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    sr, si, pay = _stream(framed)
    sr, si = sr.cuda(), si.cuda()
    half = sr.shape[-1] // 2
    before = spans.COUNTS["launch.extract_dechirp"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out, state = _receive(framed, sr[:half], si[:half])
        out2, _ = _receive(framed, sr[half:], si[half:], state)
    assert spans.COUNTS["launch.extract_dechirp"] == before + 2
    assert torch.equal(out.payload[:1].cpu(), pay[:1])
    assert torch.equal(out2.payload[:1].cpu(), pay[1:])
    got = _spans(prof)
    extract = [s for s in got if s[0] == "lora.rx.extract"]
    kernel = [s for s in got if s[0] == "lora.kernel.extract_dechirp"]
    assert len(extract) == 2 and len(kernel) == 2
    for outer, inner in zip(extract, kernel):
        assert _inside(inner, outer), (inner, outer)


@pytest.mark.cuda
def test_decoder_kernel_opens_inside_the_decoder_span_on_card():
    """On the card each framed stream call launches the framed decoder
    kernel once: one ``lora.kernel.decode_frame`` span inside each
    ``lora.codec.decode_frame``, and ``COUNTS["launch.decode_frame"]`` one
    higher a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    sr, si, pay = _stream(True)
    sr, si = sr.cuda(), si.cuda()
    half = sr.shape[-1] // 2
    before = spans.COUNTS["launch.decode_frame"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out, state = _receive(True, sr[:half], si[:half])
        out2, _ = _receive(True, sr[half:], si[half:], state)
    assert spans.COUNTS["launch.decode_frame"] == before + 2
    assert torch.equal(out.payload[:1].cpu(), pay[:1])
    assert torch.equal(out2.payload[:1].cpu(), pay[1:])
    got = _spans(prof)
    codec = [s for s in got if s[0] == "lora.codec.decode_frame"]
    kernel = [s for s in got if s[0] == "lora.kernel.decode_frame"]
    assert len(codec) == 2 and len(kernel) == 2
    for outer, inner in zip(codec, kernel):
        assert _inside(inner, outer), (inner, outer)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_collective_bytes_on_a_one_rank_mesh():
    """The sp-sharded receiver on a one-rank gloo mesh counts the bytes of
    its three collectives: the halo gather (4 planes of plen samples,
    then the block length as two words), the scan gather (3 words a window of [tail | chunk]) and the
    results' all_reduce (each slot's fields in int32 words)."""
    sr, si, pay = _stream(False)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = M.make_mesh(1, dp=1, sp=1, device="cpu")
        shard = D.stream_sharding(mesh)
        kinds = ("halo", "scan", "results")
        before = {k: spans.COUNTS["collective_bytes." + k] for k in kinds}
        out, _ = T.receive_stream(D.make_global_array(sr, shard),
                                  D.make_global_array(si, shard), P7,
                                  payload_symbols=2 * PAYLOAD,
                                  max_packets=4, mesh=mesh)
        sent = {k: spans.COUNTS["collective_bytes." + k] - before[k]
                for k in kinds}
    finally:
        dist.destroy_process_group()
    assert torch.equal(out.payload[:2], pay)
    plen = receiver.packet_samples(P7, 2 * PAYLOAD)
    stride = P7.step // 4
    # payload 8 B, crc_ok, sync_word, cfo, time_offset: one word each
    assert sent == {"halo": 4 * plen * 4 + 8,
                    "scan": 3 * (plen + sr.shape[-1]) // stride * 4,
                    "results": 4 * (PAYLOAD + 4 * 4)}
