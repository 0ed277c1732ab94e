"""ReadProfile -> device table bundle, and capacity planning."""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .tables import (EcdfDevice, KdeDevice, MixtureDevice, QualDevice, TransErrorDevice,
                          build_hp_breakpoints)
from .profile import ReadProfile


class SimTables(NamedTuple):
    """Device-side sampling state of the genome slice (aligned + unaligned)."""

    first_match: Optional[EcdfDevice]
    match_markov: Optional[EcdfDevice]
    mixtures: Optional[MixtureDevice]
    trans: Optional[TransErrorDevice]
    kde_aligned: Optional[KdeDevice]
    kde_ht: Optional[KdeDevice]
    kde_ht_ratio: Optional[KdeDevice]
    kde_unaligned: Optional[KdeDevice]
    kde_gap: Optional[KdeDevice]
    qual: Optional[QualDevice]
    strandness_rate: torch.Tensor  # scalar f32
    # homopolymer mode (None unless the profile was loaded for -hp): the
    # in-run mismatch rate and the exact f32 u-space inverse-CDF resize
    # tables ([2*(M+1), N] rows AT then CG; ops/tables.build_hp_breakpoints)
    hp_mis_rate: float = 0.0
    hp_breaks: Optional[torch.Tensor] = None  # f32
    hp_vals: Optional[torch.Tensor] = None  # int32


def build_tables(p: ReadProfile, device) -> SimTables:
    def opt(f, x):
        return None if x is None else f(x, device)

    hp_kw = {}
    if p.hp_params is not None:
        hp_br, hp_vl = build_hp_breakpoints(p.hp_params)
        hp_kw = dict(
            hp_mis_rate=float(p.hp_params.mis_rate),
            hp_breaks=torch.as_tensor(np.asarray(hp_br, np.float32), device=device),
            hp_vals=torch.as_tensor(np.asarray(hp_vl, np.int32), device=device),
        )

    return SimTables(
        first_match=opt(EcdfDevice.from_table, p.first_match),
        match_markov=opt(EcdfDevice.from_table, p.match_markov),
        mixtures=opt(MixtureDevice.from_params, p.mix_params),
        trans=opt(TransErrorDevice.from_probs, p.trans_error),
        kde_aligned=opt(KdeDevice.from_model, p.kde_aligned),
        kde_ht=opt(KdeDevice.from_model, p.kde_ht),
        kde_ht_ratio=opt(KdeDevice.from_model, p.kde_ht_ratio),
        kde_unaligned=opt(KdeDevice.from_model, p.kde_unaligned),
        kde_gap=opt(KdeDevice.from_model, p.kde_gap),
        qual=opt(QualDevice.from_params, p.base_quals),
        strandness_rate=torch.tensor(np.float32(p.strandness_rate), device=device),
        **hp_kw,
    )


def _round_up(x: int, m: int) -> int:
    return int(-(-x // m) * m)


def plan_ref_capacity(p: ReadProfile, max_len: float, max_chrom: int, margin: float = 1.18) -> int:
    """Static reference-segment buffer length.

    Upper-bounds the sampled aligned length (KDE support = max fitted point +
    6 bandwidths) inflated by `margin` for error-walk overshoot; clipped by
    the user max_len and the longest chromosome.  Every [B, L]-wide device op
    pays for this width, so the margin is tight; the vanishing tail of lanes
    that still exceed it (P < 1e-4 of draws) is rejected deterministically.
    """
    kde = p.kde_aligned if p.kde_aligned is not None else p.kde_aligned_2d
    if kde is not None:
        col = kde.data[:, -1] if kde.data.shape[1] > 1 else kde.data[:, 0]
        support = float(np.max(col)) + 6.0 * kde.bandwidth
    else:
        support = 100000.0
    cap = support * margin + 64
    cap = min(cap, float(max_len) * margin + 64 if np.isfinite(max_len) else cap, float(max_chrom))
    return max(256, _round_up(int(cap), 256))


def estimate_mean_match(p: ReadProfile) -> float:
    """Mean match-stretch length from the binned match ECDF (events per read
    ~ length / (mean_match + 1))."""
    if p.match_markov is None:
        return 10.0
    means = []
    for lane in range(p.match_markov.n_bins):
        n = p.match_markov.n_entries[lane]
        if n == 0:
            continue
        v = 0.5 * (p.match_markov.v_lo[lane, :n] + p.match_markov.v_hi[lane, :n])
        pw = np.diff(np.concatenate([[0.0], p.match_markov.p_hi[lane, :n]]))
        denom = pw.sum() or 1.0
        means.append(float((v * pw).sum() / denom))
    return max(2.0, float(np.mean(means)) if means else 10.0)


def estimate_mean_aligned(p: ReadProfile, default: float = 8000.0) -> float:
    """Mean aligned-region length from the KDE's fitted points."""
    kde = p.kde_aligned if p.kde_aligned is not None else p.kde_aligned_2d
    if kde is None:
        return default
    col = kde.data[:, -1] if kde.data.shape[1] > 1 else kde.data[:, 0]
    return float(np.mean(col))


def plan_event_budget(p: ReadProfile, l_cap: int, slack: float = 1.3) -> int:
    """Static walk-event budget: l_cap / E[match + error advance] * slack.

    The default is LEAN (event-buffer width drives the [B, E] walk buffers,
    bulk uniforms, and the event->span scatters — all per-batch costs): lanes
    whose walk overflows it are re-run through a full-budget program
    (FULL_EVENT_SLACK) by the overflow-rescue path, so the budget is an
    execution-shape choice, not an output-semantics one.
    """
    if p.match_markov is None:
        return 64
    mean_match = estimate_mean_match(p)
    budget = int(l_cap / (mean_match + 1.0) * slack) + 64
    return _round_up(min(budget, l_cap), 8)  # unroll-factor aligned


# Slack for the overflow-rescue program: effectively "unbounded" semantics
# (a walk needing more than this is rejected identically by every shape).
FULL_EVENT_SLACK = 2.8


def plan_ht_capacity(p: ReadProfile, margin: float = 1.3) -> int:
    """Static head+tail buffer length from the ht KDE's support (log10 space)."""
    if p.kde_ht is None:
        return 512
    support = 10.0 ** (float(np.max(p.kde_ht.data)) + 6.0 * p.kde_ht.bandwidth) - 1.0
    return max(128, _round_up(int(support * margin) + 16, 128))
