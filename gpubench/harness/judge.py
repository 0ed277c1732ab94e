"""The comparison that decides `correct`.

For each job of the window and each pass, the program's written reads are
checked against the plain reference (gpubench/reference):

* the index to slot map: every read index of the job written once, in
  order, and the slots rising with it (the accept loop keeps slot order);
* for each kept read (a sample drawn from the seed, and the job's longest):
  every slot between the previous read's slot and its own is one the
  reference rejects, its own slot is one the reference accepts, and the
  read's FASTQ record and its error-log rows equal the reference's bytes;
* for a sample of the skipped slot runs (drawn from the seed): every slot
  in it is one the reference rejects, so no read was left out.

A read that fails any of these counts once in `mismatched_reads`, a skipped
run that holds a read in `missed_reads`, a broken map in `order_faults`.
Each has the limit 0: the comparison is exact.
"""

from __future__ import annotations

import random

import numpy as np

MAX_GAP = 256  # slots between two written reads beyond which the map is broken
GAPS_CHECKED = 8  # skipped slot runs checked a pass


def sample_indices(seed: int, job: int, pass_name: str, quota: int, k: int) -> list:
    """The read indices a job keeps for the check, drawn from the seed."""
    r = random.Random(f"{seed}:{job}:{pass_name}")
    return sorted(r.sample(range(quota), min(k, quota))) if quota else []


def judge_pass(lanes_of, seed: int, slots: np.ndarray, contiguous: bool, quota: int,
               kept: dict) -> dict:
    """One pass of one job.  lanes_of(seed, slots) -> the reference's Lanes;
    kept: idx -> {"record", "log"} from the program's output."""
    order = 0
    if len(slots) != quota or not contiguous:
        order += 1
    if len(slots) > 1 and not bool(np.all(np.diff(slots) > 0)):
        order += 1
    if len(slots) and slots[0] < 0:
        order += 1
    want, spans = [], {}
    prev = np.concatenate([[-1], slots[:-1]]) if len(slots) else np.zeros(0, np.int64)
    skipped = np.nonzero(slots - prev > 1)[0]
    r = random.Random(f"{seed}:gaps")
    gap_idx = sorted(r.sample(list(skipped), min(GAPS_CHECKED, len(skipped))))
    gaps = []
    for i in gap_idx:
        lo = int(prev[i]) + 1
        n = min(int(slots[i]) - lo, MAX_GAP)
        gaps.append((len(want), n))
        want.extend(range(lo, lo + n))
    for idx in sorted(kept):
        if idx >= len(slots):
            continue
        lo = int(slots[idx - 1]) + 1 if idx else 0
        hi = int(slots[idx])
        if hi < lo or hi - lo > MAX_GAP:
            continue
        spans[idx] = (len(want), hi - lo + 1)
        want.extend(range(lo, hi + 1))
    lanes = lanes_of(seed, want) if want else []
    bad = []
    for idx, got in sorted(kept.items()):
        if idx not in spans:
            bad.append(idx)
            continue
        at, n = spans[idx]
        gap, own = lanes[at:at + n - 1], lanes[at + n - 1]
        if any(g.valid for g in gap) or not own.valid:
            bad.append(idx)
            continue
        record, log = own.render(idx)
        if got["record"] != record or (log is not None and (got["log"] or b"") != log):
            bad.append(idx)
    missed = sum(any(g.valid for g in lanes[at:at + n]) for at, n in gaps)
    return {"checked": len(kept), "mismatched": len(bad), "mismatched_idx": bad,
            "gaps": len(gaps), "missed": missed, "order_faults": order, "lanes": len(want)}
