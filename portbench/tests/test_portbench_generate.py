"""Each generator, at a tiny size on the CPU, plants what it reports: the
reference receiver finds every packet at its planted start with its bytes
and CRC verdict."""
from __future__ import annotations

import pytest
import torch

from portbench import generate, spec
from portbench.reference import phy as P
from portbench.reference import rx

SF7 = P.Phy(sf=7, bw=125000)
FRAMES = {"kind": "stream_frames", "stream_samples": 5376 * 10,
          "max_payload_len": 16, "length_min": 4, "length_max": 16,
          "gap_symbols": 2, "jitter_symbols": 1, "altered": 3, "sigma": 0.05,
          "windows_per_symbol": 4, "power_gate_db": 4.0,
          "slots_per_packet": 3, "pool": 2}
PACKETS = {"kind": "stream_packets", "stream_samples": 8960 * 10,
           "payload_len": 32, "gap_symbols": 2, "jitter_symbols": 1,
           "altered": 3, "sigma": 0.05, "windows_per_symbol": 4,
           "power_gate_db": 4.0, "slots_per_packet": 1, "pool": 2}
BATCH = {"kind": "packet_batch", "samples_per_call": 8448 * 12,
         "payload_len": 32, "altered": 3, "pool": 2}


def _build(mix, seed, index):
    return generate.build(spec.kind(mix["kind"]), mix, SF7, seed, index,
                          "cpu")


@pytest.mark.parametrize("mix", (FRAMES, PACKETS), ids=("frames", "packets"))
def test_stream_holds_what_it_reports(mix):
    inp = _build(mix, 2 ** 33 + 5, 1)
    t = inp.truth
    rows = spec.kind(mix["kind"]).row_symbols(mix, SF7)
    pitch = generate.pitch(mix, SF7, rows)
    assert inp.packets == 10 and inp.samples == mix["stream_samples"]
    offsets = t["start"] - torch.arange(10) * pitch
    assert bool(((offsets >= 0) & (offsets < SF7.step)).all())
    assert int(t["altered"].sum()) == 3
    frames = mix["kind"] == "stream_frames"
    got = rx.receive(*inp.args, SF7, frames=frames,
                     payload_len=16 if frames else 32,
                     max_packets=generate.slots(mix, SF7, rows),
                     stride=generate.stride(mix, SF7), gate_db=4.0,
                     prec="f64")
    rows = torch.searchsorted(got["start"], t["start"])
    assert torch.equal(got["start"][rows], t["start"])
    assert torch.equal(got["payload"][rows], t["payload"])
    assert torch.equal(got["crc_ok"][rows], ~t["altered"])
    if frames:
        assert torch.equal(got["length"][rows], t["length"])
        assert bool(((t["length"] >= 4) & (t["length"] <= 16)).all())
        past = torch.arange(16) >= t["length"][:, None]
        assert int(t["payload"][past].abs().sum()) == 0


def test_batch_holds_what_it_reports():
    inp = _build(BATCH, 3, 0)
    pay = inp.truth["payload"]
    assert inp.packets == 12 and pay.shape == (12, 32)
    assert torch.equal(inp.args[0].to(torch.int64), pay)
    ok = P.crc_sx1272(pay[:, 2:30]) == (pay[:, 30] | (pay[:, 31] << 8))
    assert torch.equal(ok, ~inp.truth["altered"])
    assert int(inp.truth["altered"].sum()) == 3


def test_same_seed_same_input_other_index_other_input():
    a = _build(PACKETS, 11, 0)
    b = _build(PACKETS, 11, 0)
    c = _build(PACKETS, 11, 1)
    assert torch.equal(a.args[0], b.args[0])
    assert not torch.equal(a.truth["payload"], c.truth["payload"])
