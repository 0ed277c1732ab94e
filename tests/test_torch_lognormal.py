"""The `-med/-sd` lognormal length draw against the JAX package, bit for bit.

`ops/xla_math.exp_f32` is XLA CPU's float32 exp written out, and
`xla_math.f32_to_i32` is XLA's saturating float32 -> int32 conversion;
`sim/genome_mode.lognormal_len` is the draw as XLA compiles the JAX
package's ``jnp.exp(z * sd + jnp.log(c))``.  Each is held against jax on the
CPU (x64 on, as the JAX package sets it): every float32 in [7, 11], 2**24
values over exp's whole range, the fused expression over a million seeded
normals at three (median, sd) pairs in both forms (c = median, and c =
median + sd**2 / 2), and the package's own draw over 100,000 slots.
Tolerance: equality of the float32 bits.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanosim_tpu.ops import rng as jrng
from nanosim_tpu_torch.ops import rng as trng
from nanosim_tpu_torch.ops import xla_math
from nanosim_tpu_torch.sim import genome_mode as tgm

import test_torch_common  # noqa: F401  (one torch thread per test worker)

# (median, sd): the JAX bench model's spread (sd 2,200 about 8,000), a narrow
# one about a short median, and a spread wide enough for draws past 2**31
PAIRS = [(8000.0, 0.27), (450.0, 0.3), (5000.0, 6.0)]
_jexp = jax.jit(jnp.exp)


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.uint32)


def _assert_exp_equal(x: np.ndarray):
    want = _bits(_jexp(jnp.asarray(x)))
    got = _bits(xla_math.exp_f32(torch.from_numpy(x)).numpy())
    bad = np.nonzero(want != got)[0]
    assert bad.size == 0, (bad.size, x[bad[:4]], want[bad[:4]], got[bad[:4]])


def test_exp_f32_equals_xla_on_every_float_in_7_to_11():
    """Every float32 from 7 to 11 (about 5.2 million values): the exponent
    range of ln(length) for lengths from 1,100 to 60,000 bases."""
    lo, hi = np.float32(7.0).view(np.int32), np.float32(11.0).view(np.int32)
    x = np.arange(lo, hi + 1, dtype=np.int32).view(np.float32)
    assert x.size > 5_000_000
    _assert_exp_equal(x)


def test_exp_f32_equals_xla_across_its_range():
    """2**24 values spread over the clamp range [-87.8, 88.8] (results from
    flushed subnormals to overflow), and the edges: zeros, infinities, NaN,
    values past either clamp, a subnormal input."""
    _assert_exp_equal(np.linspace(-87.8, 88.8, 1 << 24).astype(np.float32))
    edges = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -87.9, -88.0, -100.0, 88.9, 89.0,
                      100.0, 1e-40, -87.35, 88.72], np.float32)
    _assert_exp_equal(edges)


@pytest.mark.parametrize("perfect", [True, False], ids=["median", "median-shifted"])
@pytest.mark.parametrize("median,sd", PAIRS)
def test_fused_lognormal_expression_equals_xla(median, sd, perfect):
    """``jnp.exp(z * sd + jnp.log(c))`` jitted with float32 z, c = median or
    median + sd**2 / 2: XLA contracts the multiply-add into one fused
    multiply-add and takes the log in float64, rounded to float32."""
    c = median if perfect else median + sd**2 / 2.0
    z = np.random.default_rng(int(median * 10 + sd * 100)).standard_normal(
        1_000_000).astype(np.float32)
    want = _bits(jax.jit(lambda v: jnp.exp(v * sd + jnp.log(c)))(jnp.asarray(z)))
    got = xla_math.exp_f32(xla_math.fma32(torch.from_numpy(z),
                                          torch.tensor(np.float32(sd)),
                                          torch.tensor(np.float32(math.log(c)))))
    np.testing.assert_array_equal(_bits(got.numpy()), want)


@pytest.mark.parametrize("perfect", [True, False], ids=["median", "median-shifted"])
@pytest.mark.parametrize("median,sd", PAIRS)
def test_lognormal_len_equals_the_jax_draw(median, sd, perfect):
    """The draw itself over 100,000 slots: the JAX package's expression on
    its own normal (rng.normal_per_slot, site SITE_LOGNORMAL_LEN), jitted with
    median and sd static as genome_batch holds them, against
    genome_mode.lognormal_len."""
    assert trng.SITE_LOGNORMAL_LEN == jrng.SITE_LOGNORMAL_LEN
    slots = np.arange(1000, 101000, dtype=np.int64)
    c = median if perfect else median + sd**2 / 2.0

    def draw(s):
        sk = jrng.slot_keys(jrng.base_key(11, jrng.STREAM_ALIGNED), s)
        return jnp.exp(jrng.normal_per_slot(sk, jrng.SITE_LOGNORMAL_LEN) * sd + jnp.log(c))

    want = _bits(jax.jit(draw)(jnp.asarray(slots)))
    sk = trng.slot_keys(trng.base_key(11, trng.STREAM_ALIGNED, device="cpu"),
                        torch.from_numpy(slots))
    got = tgm.lognormal_len(sk, median, sd, perfect)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), want)


def test_f32_to_i32_saturates_like_xla():
    """XLA's float32 -> int32: truncation toward zero, saturating at the
    int32 range, NaN to 0 (torch's own cast gives INT_MIN out of range)."""
    x = np.array([3e9, -3e9, 1e38, -1e38, np.nan, np.inf, -np.inf, 2147483520.0, 2**31,
                  -2**31, -2147483904.0, 1.9, -1.9, 0.5, -0.5, 12345.99], np.float32)
    want = np.asarray(jax.jit(lambda v: v.astype(jnp.int32))(jnp.asarray(x)))
    got = xla_math.f32_to_i32(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[0]) == 2**31 - 1 and int(got[4]) == 0
