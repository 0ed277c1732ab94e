"""Binned empirical-CDF tables (`_first_match.hist`, `_match_markov_model`).

File format (written by the reference's besthit_to_histogram.py:424-486 and
parsed by simulator.py:194-231 `read_ecdf`):

    bins\t<lo>-<hi>\t<lo>-<hi>...          # one column ("lane") per bin
    0-1\t<cumprob lane0>\t<cumprob lane1>...
    1-2\t...

Each lane is a cumulative distribution over integer values; a value is sampled
by inverting the piecewise-linear CDF.  The reference keeps only rows where the
cumulative probability *changed* and stores, per kept row j:

    prob interval  (p_lo, p_hi]  ->  value interval (v_lo, v_hi)

with v_lo = previous kept row's hi value (for the first kept row:
``max(0, hi - 10*(hi-lo))``), v_hi = the row's hi value, and the LAST kept
row's v_hi patched to the final row's hi value (simulator.py:210-229).

Sampling draws p ~ U(0,1), finds j with p_lo[j] < p <= p_hi[j], and returns

    floor((p - p_lo)/(p_hi - p_lo) * (v_hi - v_lo) + v_lo)

(simulator.py:1843-1849, 1891-1903).  This module reproduces that structure
exactly but as dense, padded numpy arrays so the inversion becomes a batched
``searchsorted`` + gather on device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Padding value for probability columns beyond a lane's entry count. Must be
# > 1 so that any p in (0, 1] lands before the padding under searchsorted.
_PAD_P = 2.0


@dataclasses.dataclass
class EcdfTable:
    """Dense array form of a binned ECDF profile.

    Attributes:
      bin_lo, bin_hi: [n_bins] int64 — the conditioning-variable range of each
        lane (for `_match_markov_model` this is the previous-match-length bin;
        for `_first_match.hist` there is a single 0-50000 bin).
      p_lo, p_hi:     [n_bins, max_entries] float64 probability intervals.
      v_lo, v_hi:     [n_bins, max_entries] float64 value intervals.
      n_entries:      [n_bins] int64 number of valid entries per lane.
    """

    bin_lo: np.ndarray
    bin_hi: np.ndarray
    p_lo: np.ndarray
    p_hi: np.ndarray
    v_lo: np.ndarray
    v_hi: np.ndarray
    n_entries: np.ndarray

    @property
    def n_bins(self) -> int:
        return len(self.bin_lo)

    def select_bin(self, value: int) -> int:
        """Lane index for a conditioning value (match-markov bin selection).

        Mirrors simulator.py:1891-1893: first bin with lo <= value < hi; if the
        value is beyond the last bin, the reference's loop falls through with
        the last bin selected.
        """
        idx = int(np.searchsorted(self.bin_lo, value, side="right")) - 1
        return int(np.clip(idx, 0, self.n_bins - 1))

    def invert(self, lane: int, p: float) -> int:
        """Scalar reference inversion (used by tests; device path in ops/)."""
        n = self.n_entries[lane]
        j = int(np.searchsorted(self.p_hi[lane, :n], p, side="left"))
        j = min(j, n - 1)
        plo, phi = self.p_lo[lane, j], self.p_hi[lane, j]
        vlo, vhi = self.v_lo[lane, j], self.v_hi[lane, j]
        return int(np.floor((p - plo) / (phi - plo) * (vhi - vlo) + vlo))


def parse_ecdf_lines(lines) -> EcdfTable:
    """Parse the text format into an :class:`EcdfTable`.

    Reproduces simulator.py:194-231 (`read_ecdf`) including its first-entry
    value-floor rule and the last-interval hi-value patch.
    """
    lines = iter(lines)
    header = next(lines).strip().split()
    bin_bounds = []
    for tok in header[1:]:
        lo, hi = tok.split("-")
        bin_bounds.append((int(lo), int(hi)))
    # The reference maps columns to *sorted* bin keys (simulator.py:206); the
    # writer emits them ascending so this is normally the identity.
    order = np.argsort([b[0] for b in bin_bounds], kind="stable")
    n_lanes = len(bin_bounds)

    entries = [[] for _ in range(n_lanes)]  # per lane: (p_lo, p_hi, v_lo, v_hi)
    l_prob = [0.0] * n_lanes
    l_ratio = [0.0] * n_lanes
    last_row_hi = 0.0
    for line in lines:
        parts = line.strip().split("\t")
        if not parts or parts == [""]:
            continue
        row_lo, row_hi = (float(x) for x in parts[0].split("-"))
        last_row_hi = row_hi
        probs = [float(x) for x in parts[1:]]
        for i in range(n_lanes):
            if probs[i] == l_prob[i]:
                continue
            if l_prob[i] != 0:
                entries[i].append((l_prob[i], probs[i], l_ratio[i], row_hi))
            else:
                vlo = max(l_ratio[i], row_hi - 10.0 * (row_hi - row_lo))
                entries[i].append((l_prob[i], probs[i], vlo, row_hi))
            l_ratio[i] = row_hi
            l_prob[i] = probs[i]

    for i in range(n_lanes):
        if entries[i]:
            plo, phi, vlo, _ = entries[i][-1]
            entries[i][-1] = (plo, phi, vlo, last_row_hi)

    max_e = max(1, max(len(e) for e in entries))
    p_lo = np.zeros((n_lanes, max_e))
    p_hi = np.full((n_lanes, max_e), _PAD_P)
    v_lo = np.zeros((n_lanes, max_e))
    v_hi = np.zeros((n_lanes, max_e))
    n_entries = np.zeros(n_lanes, dtype=np.int64)
    for out_lane, col in enumerate(order):
        lane_entries = entries[col]
        n_entries[out_lane] = len(lane_entries)
        for j, (plo, phi, vlo, vhi) in enumerate(lane_entries):
            p_lo[out_lane, j] = plo
            p_hi[out_lane, j] = phi
            v_lo[out_lane, j] = vlo
            v_hi[out_lane, j] = vhi

    sorted_bounds = [bin_bounds[c] for c in order]
    return EcdfTable(
        bin_lo=np.array([b[0] for b in sorted_bounds], dtype=np.int64),
        bin_hi=np.array([b[1] for b in sorted_bounds], dtype=np.int64),
        p_lo=p_lo,
        p_hi=p_hi,
        v_lo=v_lo,
        v_hi=v_hi,
        n_entries=n_entries,
    )


def _breakpoint_cache_dir():
    import os

    # the benchmark's own (gitignored) build directory inside its checkout,
    # apart from the program's
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(here, "_build", "tables")


def exact_breakpoints(t: EcdfTable, max_p: float = 1.0):
    """Cached wrapper around :func:`_exact_breakpoints_compute`.

    The per-entry f32 boundary search is pure Python (seconds for a real
    match-markov table) and is rerun at every process start; the result is a
    pure function of the table arrays, so it caches to disk keyed by their
    digest."""
    import hashlib
    import os

    h = hashlib.sha256(b"bp-v1")
    for a in (t.bin_lo, t.bin_hi, t.p_lo, t.p_hi, t.v_lo, t.v_hi, t.n_entries):
        arr = np.ascontiguousarray(a)
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    h.update(repr(max_p).encode())
    d = _breakpoint_cache_dir()
    path = os.path.join(d, h.hexdigest()[:24] + ".npz")
    try:
        z = np.load(path)
        return z["breaks"], z["vals"], z["n_bk"]
    except Exception:
        pass
    breaks, vals, n_bk = _exact_breakpoints_compute(t, max_p)
    try:
        os.makedirs(d, exist_ok=True)
        tmp = path + f".{os.getpid()}.tmp.npz"
        np.savez(tmp, breaks=breaks, vals=vals, n_bk=n_bk)
        os.replace(tmp, path)
    except Exception:
        pass
    return breaks, vals, n_bk


def _exact_breakpoints_compute(t: EcdfTable, max_p: float = 1.0):
    """Compile an EcdfTable to EXACT float32 inverse-CDF breakpoints.

    The reference inverts its ECDFs with float64 arithmetic
    (``floor((p-plo)/(phi-plo)*(vhi-vlo)+vlo)``, simulator.py:1843-1849); a
    device re-implementation in f32 diverges at integer-crossing edges, which
    breaks both bit-identity against the reference and the host walk replay.
    This precompiles, per bin, the exact step function p -> value over the
    f32 uniforms: ``value(p) = vals[count(breaks <= p) - 1]`` where breaks[k]
    is the SMALLEST f32 p whose f64 reference inversion yields vals[k].
    Sampling then needs only f32 comparisons — identical on every platform.

    Returns (breaks [n_bins, K] f32 padded with 2.0, vals [n_bins, K] i32,
    n_bk [n_bins] i32).
    """
    n_bins = t.n_bins
    all_breaks, all_vals = [], []
    for b in range(n_bins):
        n = int(t.n_entries[b])
        breaks, vals = [], []
        for j in range(n):
            plo = float(t.p_lo[b, j])
            phi = float(t.p_hi[b, j])
            vlo = float(t.v_lo[b, j])
            vhi = float(t.v_hi[b, j])

            def g(p):
                return np.floor((p - plo) / (phi - plo) * (vhi - vlo) + vlo)

            # smallest f32 strictly greater than plo (entry interval is
            # (plo, phi] in the reference's f64 scan)
            x0 = np.float32(plo)
            while float(x0) <= plo:
                x0 = np.nextafter(x0, np.float32(np.inf))
            x_hi = np.float32(phi)  # largest f32 <= phi
            while float(x_hi) > phi:
                x_hi = np.nextafter(x_hi, np.float32(-np.inf))
            if float(x0) > float(x_hi):
                continue  # no f32 point falls inside this entry
            v_first = int(g(float(x0)))
            if not vals or vals[-1] != v_first or not breaks:
                breaks.append(np.float32(x0))
                vals.append(v_first)
            elif vals and vals[-1] == v_first:
                pass  # continues the previous segment
            # subsequent integer crossings within the entry
            v_last = int(g(float(x_hi)))
            for v in range(v_first + 1, v_last + 1):
                # smallest f32 x in (plo, phi] with g(x) >= v
                if vhi == vlo:
                    break
                x_est = plo + (v - vlo) * (phi - plo) / (vhi - vlo)
                x = np.float32(x_est)
                # walk down to the first failing, then up to first passing
                for _ in range(64):
                    prev = np.nextafter(x, np.float32(-np.inf))
                    if float(prev) <= plo or g(float(prev)) < v:
                        break
                    x = prev
                for _ in range(64):
                    if float(x) > plo and g(float(x)) >= v and float(x) <= phi:
                        break
                    x = np.nextafter(x, np.float32(np.inf))
                if float(x) > phi:
                    break
                val_here = int(g(float(x)))
                if vals and vals[-1] == val_here and breaks:
                    continue
                breaks.append(np.float32(x))
                vals.append(val_here)
        all_breaks.append(breaks)
        all_vals.append(vals)

    K = max(1, max(len(x) for x in all_breaks))
    breaks_arr = np.full((n_bins, K), 2.0, np.float32)
    vals_arr = np.zeros((n_bins, K), np.int32)
    n_bk = np.zeros(n_bins, np.int32)
    for b in range(n_bins):
        k = len(all_breaks[b])
        n_bk[b] = k
        if k:
            breaks_arr[b, :k] = all_breaks[b]
            vals_arr[b, :k] = all_vals[b]
    return breaks_arr, vals_arr, n_bk


def read_ecdf_file(path: str) -> EcdfTable:
    with open(path) as f:
        return parse_ecdf_lines(f)


def write_ecdf_file(path: str, bin_bounds, cum_probs: np.ndarray, first_token: str = "bins") -> None:
    """Write the text format from dense cumulative probabilities.

    Args:
      bin_bounds: sequence of (lo, hi) per lane.
      cum_probs: [n_rows, n_lanes] cumulative probabilities; row r covers the
        value interval r-(r+1).
    """
    cum_probs = np.atleast_2d(np.asarray(cum_probs, dtype=np.float64))
    if cum_probs.shape[1] != len(bin_bounds):
        raise ValueError("cum_probs lanes != bin_bounds")
    with open(path, "w") as f:
        f.write(first_token + "\t" + "\t".join(f"{lo}-{hi}" for lo, hi in bin_bounds) + "\n")
        for r in range(cum_probs.shape[0]):
            f.write(f"{r}-{r + 1}\t" + "\t".join(repr(float(x)) for x in cum_probs[r]) + "\n")
