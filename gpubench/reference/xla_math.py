"""Transcendentals exactly as the JAX package's CPU backend computes them.

The JAX package's float32 draws go through XLA's own `log1p` and `erf_inv`
(the KDE normals, `_ndtri`) and through the C library's `powf` (the
log-space KDEs, ``10**x - 1``).  torch's `erfinv`, `log1p` and `pow` are
other approximations: measured against jax 0.9.0 on the CPU over every
uniform the KDE draws can produce (2**23 values), torch.erfinv differed from
XLA's in 5.6M of 8.4M values, torch.log1p in 0.7M, and torch.pow(10, x) in
1.8% of a million KDE samples.  An ulp in a length draw moves a truncated
read length by one base now and then, and the output contract is byte
identity.

So this module writes those algorithms out as plain tensor operations.  Each
operation is IEEE-rounded on the CPU and on the card alike, so the result is
the same on both.  Two things XLA's CPU code generation does are reproduced:

* multiply-add pairs are contracted into fused multiply-adds.  `fma32`
  computes one in float64: the product of two float32 values is exact there,
  and the sum rounds twice (to float64, then to float32), which differs from
  a true fused result only when the float64 sum lands exactly on a float32
  rounding midpoint;
* float32 `log` is the Cephes polynomial that XLA's CPU backend emits, with
  its own contraction pattern;
* subnormal results are flushed to zero.

`pow10_f32` follows glibc's `powf` (the one XLA's CPU backend calls) for the
base 10: float64 `log2(10)` from its table, then its 32-entry `exp2`.

Checked: every float32 `erfinv` the KDE draw can produce (all 2**23 grid
points) and a million KDE samples equal the JAX package's bits
(tests/test_torch_rng.py, tests/test_torch_tables.py).
"""

from __future__ import annotations

import torch


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a * b + c with one rounding (computed in float64)."""
    a64 = a.to(torch.float64)
    b64 = b.to(torch.float64) if torch.is_tensor(b) else b
    c64 = c.to(torch.float64) if torch.is_tensor(c) else c
    return (a64 * b64 + c64).to(torch.float32)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


# Cephes logf coefficients (XLA CPU's vectorized float32 log)
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
          1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
          3.3333331174e-1)
_LOG_Q1 = -2.12194440e-4
_LOG_Q2 = 0.693359375
_SQRTHF = 0.707106781186547524


def log_f32(v: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 natural log (Cephes range reduction + polynomial)."""
    min_norm = torch.tensor(1.17549435e-38, dtype=torch.float32, device=v.device)
    x0 = torch.maximum(v, min_norm)
    bits = x0.view(torch.int32)
    e = (((bits >> 23) & 0xFF) - 126).to(torch.float32)
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    lt = m < _SQRTHF
    e = torch.where(lt, e - 1.0, e)
    x = (m - 1.0) + torch.where(lt, m, torch.zeros_like(m))
    x2 = x * x
    x3 = x2 * x
    P = [_f32(p, v) for p in _LOG_P]
    y = fma32(x, P[0], P[1])
    y1 = fma32(x, P[3], P[4])
    y2 = fma32(x, P[6], P[7])
    y = fma32(y, x, P[2])
    y1 = fma32(y1, x, P[5])
    y2 = fma32(y2, x, P[8])
    y = fma32(y, x3, y1)
    y = fma32(y, x3, y2)
    y = fma32(y, x3, e * _f32(_LOG_Q1, v))
    x = fma32(x2, _f32(-0.5, v), x)
    x = x + y
    x = fma32(e, _f32(_LOG_Q2, v), x)
    inf = torch.full_like(v, float("inf"))
    x = torch.where(v == 0, -inf, x)
    x = torch.where(v == float("inf"), inf, x)
    return torch.where((v < 0) | torch.isnan(v), torch.full_like(v, float("nan")), x)


# XLA CPU's vectorized float32 exp: the clamp, the reduction constants and
# the polynomial of Cephes' expf
_EXP_LO, _EXP_HI = -87.8, 88.8
_LOG2E = 1.44269504088896341
_EXP_C1 = 0.693359375
_EXP_C2 = -2.12194440e-4
_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
          1.6666665459e-1, 0.5)


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 exp, as its code generation emits it (read from the
    x86 code of a jitted ``jnp.exp(z * sd + c)``): x clamped to [-87.8, 88.8];
    n = floor(x * log2(e) + 0.5) clamped to [-127, 127]; r = x - n * C1 -
    n * C2; y = 1 + (r + r**2 * p(r)) with p of degree 5; the result y * 2**n,
    2**n built by adding n << 23 to the bits of 1.0.  Every multiply-add pair
    is one fused multiply-add but the r**2 product and the final ``+ 1`` and
    ``* 2**n``.  A NaN stays NaN; a subnormal result is flushed to zero."""
    x = torch.minimum(torch.maximum(x, _f32(_EXP_LO, x)), _f32(_EXP_HI, x))
    fx = torch.floor(fma32(x, _f32(_LOG2E, x), _f32(0.5, x)))
    fx = fx.clamp(-127.0, 127.0)
    r = fma32(-fx, _f32(_EXP_C1, x), x)
    r = fma32(-fx, _f32(_EXP_C2, x), r)
    p = torch.full_like(x, _EXP_P[0])
    for c in _EXP_P[1:]:
        p = fma32(p, r, _f32(c, x))
    y = fma32(p, r * r, r) + 1.0
    n = torch.nan_to_num(fx, nan=0.0).to(torch.int32)
    out = y * ((n << 23) + (127 << 23)).view(torch.float32)
    return torch.where(out.abs() < 1.17549435e-38, torch.zeros_like(out), out)


def f32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 -> int32 conversion: truncation toward zero that
    saturates at the int32 range, NaN -> 0 (torch's own gives INT_MIN for
    every value out of range)."""
    lim = torch.tensor(2.0**31, dtype=torch.float32, device=x.device)
    big = x >= lim
    small = x < -lim
    inside = torch.where(big | small | torch.isnan(x), torch.zeros_like(x), x)
    out = inside.to(torch.int32)
    out = torch.where(big, torch.full_like(out, 2**31 - 1), out)
    return torch.where(small, torch.full_like(out, -2**31), out)


_L1P_DEN = (1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
            2.2176239823732856465394E2, 3.0909872225312059774938E2,
            2.1642788614495947685003E2, 6.0118660497603843919306E1)
_L1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
            6.5787325942061044846969E0, 2.9911919328553073277375E1,
            6.0949667980987787057556E1, 5.7112963590585538103336E1,
            2.0039553499201281259648E1)


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    p = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        p = fma32(p, x, _f32(c, x))
    return p


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log1p: a Cephes rational function for |x| < sqrt(2) - 1,
    log(1 + x) otherwise."""
    large = log_f32(x + 1.0)
    x2 = x * x
    r = _horner(x, _L1P_NUM) / _horner(x, _L1P_DEN)
    r = (x * x2) * r
    r = fma32(x2, _f32(-0.5, x), r)
    small = x + r
    return torch.where(x.abs() < 0.41421356237309504880, small, large)


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
               1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
               2.83297682)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv (Giles' single-precision polynomials)."""
    w = -log1p_f32(-(x * x))
    lt = w < 5.0
    # float64 sqrt rounded once to float32 is the correctly rounded float32
    # sqrt; torch's float32 CPU sqrt is not (1 ulp off at some inputs)
    wv = torch.where(lt, w - 2.5, torch.sqrt(w.to(torch.float64)).to(torch.float32) - 3.0)

    def coeff(i):
        return torch.where(lt, _f32(_ERFINV_LT5[i], x), _f32(_ERFINV_GE5[i], x))

    p = coeff(0)
    for i in range(1, 9):
        p = fma32(p, wv, coeff(i))
    r = p * x
    return torch.where(x.abs() == 1.0, x * float("inf"), r)


# glibc powf for base 10 (its exp2f table: 2**(i/32) bit patterns with
# i << 47 pre-subtracted; the log2 of 10.0f from its 16-entry log2 table)
_EXP2_TAB = (
    0x3ff0000000000000, 0x3fefd9b0d3158574, 0x3fefb5586cf9890f, 0x3fef9301d0125b51,
    0x3fef72b83c7d517b, 0x3fef54873168b9aa, 0x3fef387a6e756238, 0x3fef1e9df51fdee1,
    0x3fef06fe0a31b715, 0x3feef1a7373aa9cb, 0x3feedea64c123422, 0x3feece086061892d,
    0x3feebfdad5362a27, 0x3feeb42b569d4f82, 0x3feeab07dd485429, 0x3feea47eb03a5585,
    0x3feea09e667f3bcd, 0x3fee9f75e8ec5f74, 0x3feea11473eb0187, 0x3feea589994cce13,
    0x3feeace5422aa0db, 0x3feeb737b0cdc5e5, 0x3feec49182a3f090, 0x3feed503b23e255d,
    0x3feee89f995ad3ad, 0x3feeff76f2fb5e47, 0x3fef199bdd85529c, 0x3fef3720dcef9069,
    0x3fef5818dcfba487, 0x3fef7c97337b9b5f, 0x3fefa4afa2a490da, 0x3fefd0765b6e4540,
)
_EXP2_C = (float.fromhex("0x1.c6af84b912394p-5"), float.fromhex("0x1.ebfce50fac4f3p-3"),
           float.fromhex("0x1.62e42ff0c52d6p-1"))
_EXP2_SHIFT = float.fromhex("0x1.8p+47")  # 0x1.8p+52 / 32
_LOG2_10 = float.fromhex("0x1.a934f0979b22dp+1")
_POW_OFLOW = float.fromhex("0x1.fffffffd1d571p+6")


def pow10_f32(x: torch.Tensor) -> torch.Tensor:
    """glibc powf(10.0f, x) for float32 x."""
    dev = x.device
    ylogx = x.to(torch.float64) * _LOG2_10
    kd = (ylogx + _EXP2_SHIFT) - _EXP2_SHIFT  # k / 32, k = round(32 * ylogx)
    r = ylogx - kd
    # clamped only so that out-of-range lanes (overwritten below) cannot
    # overflow the shifts
    k = (kd * 32.0).clamp(-8192.0, 8192.0).nan_to_num(0.0).to(torch.int64)
    i = k & 31
    tab = torch.tensor(_EXP2_TAB, dtype=torch.int64, device=dev)
    # T[i] + (i << 47) is the bit pattern of 2**(i/32); k >> 5 adds the
    # integer part to the exponent field
    t = tab[i] + (i << 47) + ((k >> 5) << 52)
    s = t.view(torch.float64)
    z = _EXP2_C[0] * r + _EXP2_C[1]
    r2 = r * r
    y = _EXP2_C[2] * r + 1.0
    y = z * r2 + y
    out = (y * s).to(torch.float32)
    out = torch.where(ylogx > _POW_OFLOW, torch.full_like(out, float("inf")), out)
    out = torch.where(ylogx <= -150.0, torch.zeros_like(out), out)
    # XLA's CPU backend flushes subnormal results to zero
    out = torch.where(out < 1.17549435e-38, torch.zeros_like(out), out)
    return torch.where(torch.isnan(x), x, out)


# XLA's CPU pipeline rewrites a long row reduction into a tree of windows
# (TreeReductionRewriter: windows of 32, the padding split low/high with the
# smaller half low) and a long cumulative sum into a blocked scan
# (ReduceWindowRewriter: blocks of 16, then a scan of the block totals, the
# same rewrite again while the totals outnumber a block).  Each window and
# each block is summed left to right from 0.  XLA's CPU code also treats
# subnormal inputs as zero; these sums take the weights exp_f32 gives, which
# are never subnormal.
_TREE_WINDOW = 32
_SCAN_BLOCK = 16


def _sequential_sum(x: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def _padded(x: torch.Tensor, low: int, high: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (low, high)) if low or high else x


def sum_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 sum along the last axis, in the order of XLA CPU's reduce."""
    n = x.shape[-1]
    if n <= _TREE_WINDOW:
        return _sequential_sum(x)
    m = -(-n // _TREE_WINDOW) * _TREE_WINDOW
    low = (m - n) // 2
    xp = _padded(x, low, m - n - low)
    return sum_f32(_sequential_sum(xp.reshape(*x.shape[:-1], m // _TREE_WINDOW, _TREE_WINDOW)))


def logsumexp_f32(x: torch.Tensor) -> torch.Tensor:
    """``jax.scipy.special.logsumexp(x, axis=-1, keepdims=True)`` for float32
    x as XLA CPU computes it: the row maximum (taken as 0 where it is not
    finite), ``log(|sum(exp(x - max))|) + max`` with XLA's exp, sum and log."""
    amax = x.amax(dim=-1, keepdim=True)
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    s = sum_f32(exp_f32(x - amax))[..., None]
    return log_f32(s.abs()) + amax


def cumsum_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``jnp.cumsum(x, axis=-1)`` in the order of XLA CPU's blocked
    scan: left-to-right prefixes within blocks of 16, each block offset by
    the exclusive prefix of the block totals, which are scanned the same way."""
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        cols = []
        for j in range(n):
            acc = acc + x[..., j]
            cols.append(acc)
        return torch.stack(cols, dim=-1)
    m = -(-n // _SCAN_BLOCK) * _SCAN_BLOCK
    p = cumsum_f32(_padded(x, 0, m - n).reshape(*x.shape[:-1], m // _SCAN_BLOCK, _SCAN_BLOCK))
    totals = cumsum_f32(p[..., -1])
    before = _padded(totals[..., :-1], 1, 0)
    return (p + before[..., None]).reshape(*x.shape[:-1], m)[..., :n]
