"""The comparisons that decide ``correct``, shared by the kinds.

Each cell's outputs are held to the plain reference (``reference/``) run
on the same inputs, and to what the generator planted; the cell's kind
(``kinds/<kind>.py``) says which comparison and which numbers.  Each
number has its limit in ``portbench/limits/<cell>.json``; a run is
correct when every number is at or under its limit.

Stream cells (``receive_stream`` / ``receive_stream_frames``):

- ``missed``: planted packets not returned exactly once at their planted
  start (exact: limit 0);
- ``wrong_planted``: returned planted packets whose bytes, length, header
  and CRC verdicts, sync word or FEC count differ from the reference's
  decode at that start, or from what was planted (exact);
- ``false_pass``: other candidates (sync matches inside frames) whose CRC
  passes (exact);
- ``cand_diff``: candidate starts the program and the reference do not
  share, leaving out those decided by a window on a rounding tie
  (``reference/rx.py::TIE_SHARE``, ``TIE_DB``), plus the difference in
  dropped candidates (exact);
- ``est_moved``: the share (%) of returned planted packets whose CFO or
  timing estimate is not the reference's to the last bit.  The reference
  takes its DFTs in float64 and closes the estimate in float32, as the
  configuration states; a float32 receiver differs from it only where its
  own DFT rounding carries the mean bin across a float32 step.

Batch cells (``encode -> modulate_dechirped -> demodulate_tones ->
decode``):

- ``wrong_rows``: packets whose symbols, sync word, bytes or CRC verdict
  differ from the reference's or from what was planted (exact);
- ``tx_gap``: the widest gap of a pre-dechirped IQ sample from the
  reference's;
- ``db_gap``: the widest gap of a symbol's peak power (dB) from the
  reference's.
"""
from __future__ import annotations

import torch

__all__ = ["stream", "batch", "stream_rows", "STREAM", "BATCH"]

STREAM = ("missed", "wrong_planted", "false_pass", "cand_diff", "est_moved")
BATCH = ("wrong_rows", "tx_gap", "db_gap")


def _row_of(starts, wanted):
    """For each wanted start: the row of ``starts`` (ascending, unique
    where it matters) that holds it, and how many rows hold it."""
    lo = torch.searchsorted(starts, wanted, side="left")
    hi = torch.searchsorted(starts, wanted, side="right")
    return torch.clamp(lo, max=max(starts.numel() - 1, 0)), hi - lo


def _tie_excused(starts, ref, phy, stride: int, hop: int):
    """Candidate starts whose flag is decided by a window on a rounding
    tie: any tie among the windows that can flag a packet at that start
    (misalignment up to n/2 samples), the window a symbol later, and the
    one before (the duplicate rule)."""
    tie = ref["fragile"].to(torch.int64)
    csum = torch.nn.functional.pad(torch.cumsum(tie, 0), (1, 0))
    ext = starts + ref["plen"]
    lo = torch.clamp(torch.div(ext - phy.n // 2, stride,
                               rounding_mode="floor") - 1, 0, tie.numel())
    hi = torch.clamp(torch.div(ext + phy.n // 2, stride,
                               rounding_mode="floor") + hop + 1, 0,
                     tie.numel())
    return (csum[hi] - csum[lo]) > 0


def stream(got: dict, ref: dict, truth: dict, phy, frames: bool,
           stride: int) -> dict:
    """A stream call's numbers (``STREAM``)."""
    dev = ref["start"].device
    g_start = got["start"].to(dev)
    planted = truth["start"].to(dev)
    row, hits = _row_of(g_start, planted)
    found = hits == 1
    out = {"missed": int((~found).sum())}
    rrow, rhits = _row_of(ref["start"], planted)
    keys = ["payload", "crc_ok", "sync_word"]
    if frames:
        keys += ["length", "hdr_ok", "n_err"]
    wrong = ~(rhits == 1)
    for k in keys:
        a = got[k].to(dev)[row].to(torch.int64)
        b = ref[k][rrow].to(torch.int64)
        diff = a != b
        wrong |= diff.reshape(diff.shape[0], -1).any(dim=1)
    # what was planted: the bytes, and the CRC verdict of an altered one
    want = truth["payload"].to(dev).to(torch.int64)
    pay = got["payload"].to(dev)[row].to(torch.int64)[:, :want.shape[1]]
    wrong |= (pay != want).any(dim=1)
    wrong |= got["crc_ok"].to(dev)[row] == truth["altered"].to(dev)
    wrong |= got["sync_word"].to(dev)[row].to(torch.int64) != phy.sync_word
    if frames:
        wrong |= got["length"].to(dev)[row].to(torch.int64) != truth["length"]
        wrong |= ~got["hdr_ok"].to(dev)[row]
    out["wrong_planted"] = int((wrong & found).sum())
    others = torch.ones(g_start.numel(), dtype=torch.bool, device=dev)
    others[row[found]] = False
    out["false_pass"] = int((got["crc_ok"].to(dev) & others).sum())
    hop = phy.step // stride
    only_got = g_start[~torch.isin(g_start, ref["start"])]
    only_ref = ref["start"][~torch.isin(ref["start"], g_start)]
    unexcused = sum(int((~_tie_excused(s, ref, phy, stride, hop)).sum())
                    for s in (only_got, only_ref))
    out["cand_diff"] = unexcused + abs(got["n_dropped"] - ref["n_dropped"])
    both = found & (rhits == 1)
    moved = torch.zeros_like(both)
    for key in ("cfo", "time_offset"):
        moved |= got[key].to(dev)[row] != ref[key][rrow].to(got[key].dtype)
    out["est_moved"] = (100.0 * float((moved & both).sum())
                        / max(1, int(both.sum())))
    return out


def batch(got: dict, ref: dict, truth: dict, phy) -> dict:
    """A batch call's numbers (``BATCH``)."""
    dev = ref["payload"].device
    wrong = (got["symbols"].to(dev).to(torch.int64) != ref["symbols"]).any(1)
    wrong |= got["sync_word"].to(dev).to(torch.int64) != ref["sync_word"]
    wrong |= got["sync_word"].to(dev).to(torch.int64) != phy.sync_word
    pay = got["payload"].to(dev).to(torch.int64)
    wrong |= (pay != ref["payload"]).any(1) | (pay != truth["payload"]).any(1)
    ok = got["crc_ok"].to(dev)
    wrong |= (ok != ref["crc_ok"]) | (ok == truth["altered"])
    tx = max(float((got[k].to(dev).to(torch.float64) - ref[k]).abs().max())
             for k in ("dr", "di"))
    db = float((got["power"].to(dev).to(torch.float64)
                - ref["power"].to(torch.float64)).abs().max())
    return {"wrong_rows": int(wrong.sum()), "tx_gap": tx, "db_gap": db}


def stream_rows(out) -> dict:
    """A stream receiver's outputs as the dict ``stream`` compares: its
    valid slots (ascending starts) and its counts; a dict (the control's
    outputs) as it is."""
    if isinstance(out, dict):
        return out
    fields = out._asdict()
    valid = fields.pop("valid")
    got = {k: v[valid] for k, v in fields.items()
           if k not in ("n_candidates", "n_dropped")}
    got["n_candidates"] = int(fields["n_candidates"])
    got["n_dropped"] = int(fields["n_dropped"])
    return got
