"""Device-resident sampling tables (dataclasses of torch tensors).

Every distribution the reference samples in its per-read Python loops is
compiled here into a dense inverse-CDF table so a draw becomes
uniform -> compare/count -> gather, fully batched:

* ECDF tables (`first_match`, `match_markov`) — direct array form of the
  reference's interval dicts (profiles/ecdf.py).
* Mixture length distributions (pois_geom / wei_geom, mixed_model.py:41-63) —
  exact CDFs of the mixtures, tabulated to a length cap.
* Truncated log-normal base qualities (model_base_qualities.py:9-20) —
  exact f32 inverse-CDF breakpoints (build_qual_breakpoints).
* KDE length models — fitted points + bandwidth.
* Homopolymer run resizing (mutate_homo, simulator.py:618-705) — exact f32
  u-space breakpoints (build_hp_breakpoints), held as plain tensors in
  SimTables.

The numpy table builders are copies of the JAX package's; the classes hold
torch tensors on an explicit device and compute the same counts as its
device classes, bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ecdf import EcdfTable, exact_breakpoints
from .error_model import MixtureParams
from .kde import KdeModel
from . import xla_math


@dataclasses.dataclass
class EcdfDevice:
    """Batched inverse-CDF lookup for a binned ECDF profile.

    Compiled to EXACT f32 breakpoints (profiles/ecdf.exact_breakpoints):
    inversion is pure f32 comparisons + one gather, so the result is
    bit-identical across devices and the C++ walk replay, and matches the
    reference's float64 floor arithmetic by construction.
    """

    bin_lo: torch.Tensor  # [n_bins] int32
    breaks: torch.Tensor  # [n_bins, K] f32 (padded with 2.0)
    vals: torch.Tensor  # [n_bins, K] int32
    n_bk: torch.Tensor  # [n_bins] int32

    @classmethod
    def from_table(cls, t: EcdfTable, device) -> "EcdfDevice":
        breaks, vals, n_bk = exact_breakpoints(t)
        # the walks' count-compare inversion relies on each bin's value
        # sequence being non-decreasing — guaranteed by the parser (entry
        # value intervals are consecutive row ranges) but asserted here
        # because a violation would silently corrupt the walk.
        for b in range(vals.shape[0]):
            k = int(n_bk[b])
            if k > 1 and np.any(np.diff(vals[b, :k]) < 0):
                raise ValueError("ECDF bin values are not monotone")
        return cls(
            bin_lo=torch.as_tensor(np.asarray(t.bin_lo), dtype=torch.int32, device=device),
            breaks=torch.as_tensor(np.asarray(breaks, np.float32), device=device),
            vals=torch.as_tensor(np.asarray(vals, np.int32), device=device),
            n_bk=torch.as_tensor(np.asarray(n_bk, np.int32), device=device),
        )

    def select_bin(self, value: torch.Tensor) -> torch.Tensor:
        """[B] conditioning values -> [B] bin indices: ``count(bin_lo <=
        value) - 1``, clamped (fall-through, simulator.py:1891-1893)."""
        n = self.bin_lo.shape[0]
        cnt = (self.bin_lo[None, :] <= value[:, None]).sum(dim=-1)
        return (cnt - 1).clamp(0, n - 1).to(torch.int32)

    def invert(self, lane: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """Batched CDF inversion: [B] bins, [B] uniforms -> [B] int32 values.

        value = vals[count(breaks <= p) - 1] (count 0 — a p at or below the
        distribution's support — clamps to the first segment).
        """
        lane = lane.long()
        rows = self.breaks[lane]  # [B, K]
        cnt = (rows <= p[:, None]).sum(dim=-1)
        idx = torch.minimum((cnt - 1).clamp_min(0), self.n_bk[lane].long() - 1)
        return self.vals[lane, idx]


def _pois_geom_cdf(lam, p, w, n_max):
    """CDF of the reference's pois_geom draw (mixed_model.py:41-49):
    value = Poisson(lam)+1 with prob w, else Geometric(p) (support >= 1)."""
    ns = np.arange(1, n_max + 1)
    from scipy.stats import geom, poisson

    pois_pmf = poisson.pmf(ns - 1, lam)
    geom_pmf = geom.pmf(ns, p)
    pmf = w * pois_pmf + (1 - w) * geom_pmf
    cdf = np.cumsum(pmf)
    return np.clip(cdf / max(cdf[-1], 1e-12), 0.0, 1.0)


def _wei_geom_cdf(lam, k, p, w, n_max):
    """CDF of the reference's wei_geom draw (mixed_model.py:52-63):
    value = ceil(lam * Weibull(k)) with prob w, else Geometric(p)-1;
    any 0 is clamped to 1."""
    ns = np.arange(1, n_max + 1)
    from scipy.stats import geom

    # P(ceil(lam*W) <= n) = P(W <= n/lam) = 1 - exp(-(n/lam)^k)
    wei_cdf = 1.0 - np.exp(-np.power(ns / lam, k))
    # geometric-1: support 0..; CDF at n is geom.cdf(n+1, p)
    geom_cdf = geom.cdf(ns + 1, p)
    cdf = w * wei_cdf + (1 - w) * geom_cdf  # 0→1 clamp folds P(0) into P(1)
    return np.clip(cdf / max(cdf[-1], 1e-12), 0.0, 1.0)



@dataclasses.dataclass
class MixtureDevice:
    """Inverse-CDF tables for the three error-length distributions.

    Row order matches the walk's error-type encoding: 0=mis, 1=ins, 2=del.
    `cdf_t` is the f32-saturation-truncated prefix of `cdf`: entries equal to
    1.0f can never satisfy ``cdf < u`` for a u in [0, 1), so counting over the
    prefix of entries strictly below 1.0f is EXACTLY equal to counting over
    the full row.

    Every row of `cdf_t` is non-decreasing (a CDF; checked at construction):
    then ``count(row < u)`` is the index of the row's first entry >= u, which
    the unaligned walk's kernel finds by a binary search.
    """

    cdf: torch.Tensor  # [3, n_max] f32
    cdf_t: torch.Tensor  # [3, n_t] f32, n_t = rounded-up count of sub-1.0f entries

    def __post_init__(self):
        if not bool((self.cdf_t[:, 1:] >= self.cdf_t[:, :-1]).all()):
            raise ValueError("MixtureDevice: every row of cdf_t must be non-decreasing "
                             "(a NaN breaks it too)")

    @classmethod
    def from_params(cls, params: MixtureParams, device, n_max: int = 1024) -> "MixtureDevice":
        mis = _pois_geom_cdf(params.mis[0], params.mis[2], params.mis[3], n_max)
        ins = _wei_geom_cdf(params.ins[0], params.ins[1], params.ins[2], params.ins[3], n_max)
        dele = _wei_geom_cdf(params.dele[0], params.dele[1], params.dele[2], params.dele[3], n_max)
        arr = np.stack([mis, ins, dele]).astype(np.float32)
        n_t = int((arr < 1.0).sum(axis=1).max())
        n_t = min(n_max, max(64, -(-n_t // 64) * 64))
        return cls(
            cdf=torch.as_tensor(arr, device=device),
            cdf_t=torch.as_tensor(np.ascontiguousarray(arr[:, :n_t]), device=device),
        )

    def sample(self, etype: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """[B] error types, [B] uniforms -> [B] int32 lengths >= 1."""
        rows = self.cdf_t[etype.long()]
        return ((rows < u[:, None]).sum(dim=-1) + 1).to(torch.int32)


@dataclasses.dataclass
class TransErrorDevice:
    """Cumulative error-type transition rows, ERROR_STATES x {mis,ins,del}."""

    cum: torch.Tensor  # [7, 3] f32 cumulative probs

    @classmethod
    def from_probs(cls, probs: np.ndarray, device) -> "TransErrorDevice":
        return cls(cum=torch.as_tensor(np.cumsum(probs, axis=1).astype(np.float32), device=device))

    def sample(self, state: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """[B] state indices, [B] uniforms -> [B] error type (0/1/2).

        `<=` matches the reference's half-open intervals `k[0] <= p < k[1]`
        (error_list, simulator.py:1860-1863) at exact boundary values.
        """
        rows = self.cum[state.long()]
        return (rows <= u[:, None]).sum(dim=-1).clamp_max(2).to(torch.int32)


@dataclasses.dataclass
class KdeDevice:
    """Gaussian KDE sampling state."""

    data: torch.Tensor  # [n, d] f32
    bandwidth: torch.Tensor  # scalar f32
    log_transform: bool

    @classmethod
    def from_model(cls, m: KdeModel, device) -> "KdeDevice":
        return cls(
            data=torch.as_tensor(np.asarray(m.data, np.float32), device=device),
            bandwidth=torch.tensor(np.float32(m.bandwidth), device=device),
            log_transform=bool(m.log_transform),
        )

    def sample(self, u_comp: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """u_comp ~ U(0,1) [B], z ~ N(0,1) [B] (or [B, d]) -> samples.

        Mirrors sklearn KernelDensity.sample: data[floor(u*n)] + bw * z
        (one fused multiply-add, as XLA's CPU backend contracts it), then
        the reference's 10**x - 1 for log-space models (simulator.py:234-241).
        """
        n = self.data.shape[0]
        i = (u_comp * n).to(torch.int32).clamp_max(n - 1).long()
        picked = self.data[i]  # [B, d]
        if z.dim() == 1:
            z = z[:, None]
        out = xla_math.fma32(self.bandwidth.expand_as(z), z, picked)
        if self.log_transform:
            out = xla_math.pow10_f32(out) - 1.0
        return out[:, 0] if out.shape[1] == 1 else out

def build_qual_breakpoints(params: dict, classes) -> tuple:
    """Disk-cached wrapper around :func:`_build_qual_breakpoints_compute`
    (the f32 boundary searches cost ~0.4 s per process start)."""
    import hashlib
    import os

    from .ecdf import _breakpoint_cache_dir

    h = hashlib.sha256(b"qbp-v1")
    for c in classes:
        h.update(f"{c}:{params[c]['sd']!r}:{params[c]['mu']!r};".encode())
    d = _breakpoint_cache_dir()
    path = os.path.join(d, "q" + h.hexdigest()[:24] + ".npz")
    try:
        z = np.load(path)
        return z["breaks"], z["vals"]
    except Exception:
        pass
    br, vl = _build_qual_breakpoints_compute(params, classes)
    try:
        os.makedirs(d, exist_ok=True)
        tmp = path + f".{os.getpid()}.tmp.npz"
        np.savez(tmp, breaks=br, vals=vl)
        os.replace(tmp, path)
    except Exception:
        pass
    return br, vl


def _build_qual_breakpoints_compute(params: dict, classes) -> tuple:
    """Exact f32 inverse-CDF breakpoints for the truncated log-normal base
    qualities (model_base_qualities.py:9-20, truncation to [1, 93]).

    The quality for a uniform u is the non-decreasing step function
        val(u) = clip(int(exp(mu + sd * ndtri(u * (F93 - F1) + F1))), 1, 93)
    evaluated here in FLOAT64 (scipy semantics).  breaks[c, j] is the
    SMALLEST f32 u whose f64 value is vals[c, j]; sampling then needs only
    f32 comparisons — identical on every platform and in the host
    reconstruction mirrors.  (The previous analytic form used XLA's f32
    erfinv, whose integer outputs MEASURABLY DIFFER between the TPU and CPU
    backends.)

    Returns (breaks [C, K] f32 padded with 2.0, vals [C, K] int32).  Each
    row starts with a sentinel break at 0.0 so count(breaks <= u) >= 1 for
    any u in [0, 1).
    """
    from scipy.special import ndtr, ndtri

    all_breaks, all_vals = [], []
    for c in classes:
        sd = float(params[c]["sd"])
        mu = float(params[c]["mu"])
        scale = float(np.exp(mu))
        # lognorm.cdf(x, sd, scale=e^mu) == ndtr((log x - mu) / sd)
        lo = float(ndtr((np.log(1.0) - mu) / sd))
        hi = float(ndtr((np.log(93.0) - mu) / sd))

        def val(u_f32):
            q = float(u_f32) * (hi - lo) + lo
            q = min(max(q, 1e-300), 1.0 - 1e-16)
            x = np.exp(mu + sd * ndtri(q))
            return int(min(max(int(x), 1), 93))

        breaks = [np.float32(0.0)]
        vals = [val(np.float32(0.0))]
        # f32 values in [0, 1) order identically to their bit patterns
        hi_bits = int(np.array(1.0, np.float32).view(np.int32))
        u_of = lambda b: np.array(b, np.int32).view(np.float32)
        v_max = val(u_of(hi_bits - 1))
        for v in range(vals[0] + 1, v_max + 1):
            if val(u_of(hi_bits - 1)) < v:
                continue
            # analytic estimate of the crossing (u where q reaches cdf(v)),
            # then a short bit-walk to the exact smallest f32; falls back to
            # full bisection if the estimate was off by more than 64 ulps
            u_est = (float(ndtr((np.log(float(v)) - mu) / sd)) - lo) / (hi - lo)
            b = int(np.clip(np.array(max(u_est, 0.0), np.float32).view(np.int32),
                            0, hi_bits - 1))
            lo_b, hi_b = 0, hi_bits - 1
            for _ in range(64):
                if val(u_of(b)) >= v:
                    hi_b = b
                    if b == 0 or val(u_of(b - 1)) < v:
                        lo_b = b
                        break
                    b -= 1
                else:
                    lo_b = b + 1
                    if val(u_of(b + 1)) >= v:
                        hi_b = b + 1
                        lo_b = b + 1
                        break
                    b += 1
            while lo_b < hi_b:
                mid = (lo_b + hi_b) // 2
                if val(u_of(mid)) >= v:
                    hi_b = mid
                else:
                    lo_b = mid + 1
            got = val(u_of(lo_b))
            if got != vals[-1]:
                breaks.append(u_of(lo_b))
                vals.append(got)
        all_breaks.append(breaks)
        all_vals.append(vals)

    K = max(len(b) for b in all_breaks)
    br = np.full((len(classes), K), 2.0, np.float32)
    vl = np.zeros((len(classes), K), np.int32)
    for i, (b, v) in enumerate(zip(all_breaks, all_vals)):
        br[i, : len(b)] = b
        vl[i, : len(v)] = v
    return br, vl


HP_M_TAB = 1024  # tabulated run-length cap for the resize sampler


def build_hp_breakpoints_from_vecs(mu_at, mu_cg, sd_at, sd_cg,
                                   m_tab: int = HP_M_TAB):
    """Exact f32 u-space inverse-CDF tables for homopolymer run resizing.

    Reference semantics (mutate_homo, simulator.py:618-705): a run of length
    m resizes to round(max(Normal(mu(m), sd(m)), 0)).  The normal draw is
    replaced by a uniform u and an exact inverse-CDF table so the integer
    result is a pure f32-comparison function of u — identical on every
    device, in numpy and in the C++ mirror (a float32 erfinv measurably
    differs between backends; same hazard build_qual_breakpoints closed for
    base qualities).

    The new-size step function in f64 (the defining semantics):
        n(u) = int(round_half_even(max(mu + sd * ndtri(clip(u)), 0.0)))
    with mu = const + alpha1*m + beta1*max(m - bp1, 0), sd = max(i + s*m, 0)
    evaluated in f64 from the profile's f64 regression parameters.  Uniform
    draws are exactly the grid {j * 2^-23} (the uniform's bit construction),
    so breaks[row, t] is the smallest grid value whose n reaches
    vals[row, t]; sampling is count(breaks <= u) - 1.

    Runs longer than m_tab use the m_tab row (a documented deviation: real
    nanopore homopolymers are far below 1024 bases, and a bounded table keeps
    the device shapes static).

    Returns (breaks [2*(m_tab+1), N] f32 rows [AT..., CG...], vals i32).
    """
    from scipy.special import ndtri

    J = 1 << 23
    ms = np.arange(m_tab + 1, dtype=np.float64)

    def mu_of(par):
        return par[0] + par[1] * ms + par[2] * np.maximum(ms - par[3], 0.0)

    mu = np.concatenate([mu_of(np.asarray(mu_at, np.float64)),
                         mu_of(np.asarray(mu_cg, np.float64))])
    sd_at = np.asarray(sd_at, np.float64)
    sd_cg = np.asarray(sd_cg, np.float64)
    sd = np.concatenate([sd_at[0] + sd_at[1] * ms, sd_cg[0] + sd_cg[1] * ms])
    sd = np.maximum(sd, 0.0)
    R = mu.shape[0]

    def val_at(j, mu_v, sd_v):
        q = np.clip(j * (1.0 / J), 1e-300, 1.0 - 1e-16)
        return np.round(np.maximum(mu_v + sd_v * ndtri(q), 0.0)).astype(np.int64)

    v_lo = val_at(np.zeros(R), mu, sd)
    v_hi = val_at(np.full(R, J - 1, np.float64), mu, sd)
    counts = v_hi - v_lo
    total = int(counts.sum())
    if total > 20_000_000:
        raise ValueError(
            f"homopolymer breakpoint table too large ({total} transitions); "
            "profile sd regression is degenerate"
        )

    # flatten all (row, target value) pairs; one vectorized 23-step binary
    # search finds the smallest grid index whose n reaches each target
    row_of = np.repeat(np.arange(R), counts)
    offs = np.concatenate([np.arange(1, c + 1) for c in counts]) if total else np.zeros(0, np.int64)
    v_t = v_lo[row_of] + offs
    mu_f = mu[row_of]
    sd_f = sd[row_of]
    lo = np.zeros(total, np.int64)
    hi = np.full(total, J - 1, np.int64)
    for _ in range(24):
        mid = (lo + hi) >> 1
        pred = val_at(mid.astype(np.float64), mu_f, sd_f) >= v_t
        hi = np.where(pred, mid, hi)
        lo = np.where(pred, lo, mid + 1)

    # group per row; duplicate grid indices (n jumping >1 per u step) keep
    # only the largest value — count(breaks <= u) already lands on the last
    # equal break, so dropping the shadowed entries just tightens the table
    row_entries = [[(np.float32(0.0), int(v))] for v in v_lo]
    for t in range(total):
        r = int(row_of[t])
        b = np.float32(lo[t] * (1.0 / J))
        ent = row_entries[r]
        if ent[-1][0] == b:
            ent[-1] = (b, int(v_t[t]))
        else:
            ent.append((b, int(v_t[t])))
    N = max(len(e) for e in row_entries)
    breaks = np.full((R, N), 2.0, np.float32)
    vals = np.zeros((R, N), np.int32)
    for r, ent in enumerate(row_entries):
        breaks[r, : len(ent)] = [b for b, _ in ent]
        vals[r, : len(ent)] = [v for _, v in ent]
    return breaks, vals


def _hp_param_vecs(hp_params):
    """HomopolymerParams -> (mu_at, mu_cg, sd_at, sd_cg) f64 vectors."""
    def pw_vec(d):
        bps = sorted(k for k in d if "breakpoint" in k)
        betas = sorted(k for k in d if "beta" in k)
        if len(bps) != 1 or len(betas) != 1:
            raise ValueError("device hp path supports exactly one breakpoint")
        return np.asarray(
            [d["const"], d["alpha1"], d[betas[0]], d[bps[0]]], np.float64
        )

    lr = lambda d: np.asarray([d["intercept"], d["slope"]], np.float64)
    return (pw_vec(hp_params.pw["AT"]), pw_vec(hp_params.pw["CG"]),
            lr(hp_params.lr["AT"]), lr(hp_params.lr["CG"]))


def build_hp_breakpoints(hp_params, m_tab: int = HP_M_TAB):
    """Disk-cached wrapper around :func:`build_hp_breakpoints_from_vecs`."""
    import hashlib
    import os

    from .ecdf import _breakpoint_cache_dir

    mu_at, mu_cg, sd_at, sd_cg = _hp_param_vecs(hp_params)
    h = hashlib.sha256(b"hpbp-v1")
    for a in (mu_at, mu_cg, sd_at, sd_cg):
        h.update(repr([float(x) for x in a]).encode())
    h.update(str(m_tab).encode())
    d = _breakpoint_cache_dir()
    path = os.path.join(d, "hp" + h.hexdigest()[:24] + ".npz")
    try:
        z = np.load(path)
        return z["breaks"], z["vals"]
    except Exception:
        pass
    br, vl = build_hp_breakpoints_from_vecs(mu_at, mu_cg, sd_at, sd_cg, m_tab)
    try:
        os.makedirs(d, exist_ok=True)
        tmp = path + f".{os.getpid()}.tmp.npz"
        np.savez(tmp, breaks=br, vals=vl)
        os.replace(tmp, path)
    except Exception:
        pass
    return br, vl


def hp_resize_lookup(breaks: np.ndarray, vals: np.ndarray, is_at, m, u):
    """Numpy twin of the device table lookup (sampling side): n for uniform u
    drawn for a run of length m in pool AT (is_at) or CG."""
    R = breaks.shape[0]
    M = R // 2 - 1
    row = (0 if is_at else M + 1) + min(int(m), M)
    cnt = int(np.searchsorted(breaks[row], np.float32(u), side="right"))
    return int(vals[row, cnt - 1])


@dataclasses.dataclass
class QualDevice:
    """Exact breakpoint table for truncated log-normal base qualities.

    Class order: 0=match, 1=mis, 2=ins, 3=ht, 4=unmapped
    (model_base_qualities.py:120-130; truncation to [1, 93]).  The
    read-emitting programs sample it on the device; the host reconstruction
    samples the same table.
    """

    breaks: torch.Tensor  # [5, K] f32, row-sorted, sentinel 0.0 first, pad 2.0
    vals: torch.Tensor  # [5, K] int32 (non-decreasing per row)

    CLASSES = ("match", "mis", "ins", "ht", "unmapped")

    @classmethod
    def from_params(cls, params: dict, device) -> "QualDevice":
        br, vl = build_qual_breakpoints(params, cls.CLASSES)
        return cls(breaks=torch.as_tensor(br, device=device),
                   vals=torch.as_tensor(vl, device=device))

    def sample(self, qclass: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """[..] class indices + uniforms -> int32 qualities in [1, 93].

        count(breaks[c] <= u) per class via searchsorted (right=True), row
        select arithmetically, then one flat value gather.  The 0.0 sentinel
        guarantees count >= 1; padding 2.0 caps it at the row's entry count,
        so no clamping is needed.
        """
        C, K = self.breaks.shape
        uf = u.reshape(-1).contiguous()
        qf = qclass.reshape(-1)
        cnt = torch.zeros(uf.shape, dtype=torch.int32, device=uf.device)
        for c in range(C):
            cc = torch.searchsorted(self.breaks[c].contiguous(), uf, right=True).to(torch.int32)
            cnt = torch.where(qf == c, cc, cnt)
        idx = qf.to(torch.int32) * K + (cnt - 1)
        return self.vals.reshape(-1)[idx.long()].reshape(u.shape)
