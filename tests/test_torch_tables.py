"""The port's table builders, device table classes and KDE pickles against
the JAX package, exactly."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nanosim_tpu.ops import tables as jtab
from nanosim_tpu.profiles import kde as jkde
from nanosim_tpu_torch.profiles import kde as tkde
from nanosim_tpu_torch.profiles import profile as tprofile
from nanosim_tpu_torch.sim import bundles as tbundles

from test_torch_common import load_both, make_model, tables_to_numpy

N = 20_000
FIXTURE_0221 = os.path.join(os.path.dirname(__file__), "fixtures", "kde_sklearn_0221.pkl")


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    prefix = make_model(str(tmp_path_factory.mktemp("tabmodel")))
    return (prefix,) + load_both(prefix, fastq=True)


def _torch_tables_numpy(t) -> dict:
    d = {}
    for name, v in t._asdict().items():
        if v is None:
            continue
        if dataclasses.is_dataclass(v):
            for f in dataclasses.fields(v):
                a = getattr(v, f.name)
                d[f"{name}.{f.name}"] = a.numpy() if torch.is_tensor(a) else np.asarray(a)
        elif torch.is_tensor(v):  # hp_mis_rate is a plain float (0.0 without -hp)
            d[name] = v.numpy()
    return d


def _eq(a, b, msg=""):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind == "f":
        np.testing.assert_array_equal(a.astype(np.float32).view(np.int32),
                                      b.astype(np.float32).view(np.int32), err_msg=msg)
    else:
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64), err_msg=msg)


def test_build_tables_equal_jax(model):
    """The port's own loader + build_tables give the JAX package's arrays,
    and tables_from_numpy reproduces them."""
    prefix, _, jt, from_np = model
    prof = tprofile.load_profile(prefix, mode="genome", fastq=True)
    own = _torch_tables_numpy(tbundles.build_tables(prof, "cpu"))
    want = tables_to_numpy(jt)
    assert sorted(own) == sorted(want)
    for k in want:
        _eq(want[k], own[k], k)
    conv = _torch_tables_numpy(from_np)
    for k in want:
        _eq(want[k], conv[k], k)


def test_ecdf_device(model):
    _, _, jt, tt = model
    rs = np.random.default_rng(0)
    for name in ("first_match", "match_markov"):
        j, t = getattr(jt, name), getattr(tt, name)
        nb = j.breaks.shape[0]
        lane = rs.integers(0, nb, N).astype(np.int32)
        p = rs.random(N).astype(np.float32)
        p[:4] = [0.0, np.nextafter(np.float32(1), np.float32(0)), 0.5, 1e-9]
        want = j.invert(jnp.asarray(lane), jnp.asarray(p))
        _eq(want, t.invert(torch.from_numpy(lane), torch.from_numpy(p)), name)
        _eq(j.invert_all(jnp.asarray(lane), jnp.asarray(p)),
            t.invert(torch.from_numpy(lane), torch.from_numpy(p)), name)
        v = rs.integers(-5, 400, N).astype(np.int32)
        _eq(j.select_bin(jnp.asarray(v)), t.select_bin(torch.from_numpy(v)), name)


def test_mixture_and_transition_sampling(model):
    _, _, jt, tt = model
    rs = np.random.default_rng(1)
    u = rs.random(N).astype(np.float32)
    et = rs.integers(0, 3, N).astype(np.int32)
    _eq(jt.mixtures.sample_all(jnp.asarray(et), jnp.asarray(u)),
        tt.mixtures.sample(torch.from_numpy(et), torch.from_numpy(u)))
    _eq(jt.mixtures.sample(jnp.asarray(et), jnp.asarray(u)),
        tt.mixtures.sample(torch.from_numpy(et), torch.from_numpy(u)))
    st = rs.integers(0, 7, N).astype(np.int32)
    _eq(jt.trans.sample_all(jnp.asarray(st), jnp.asarray(u)),
        tt.trans.sample(torch.from_numpy(st), torch.from_numpy(u)))


@pytest.mark.parametrize("name", ["kde_aligned", "kde_ht", "kde_ht_ratio", "kde_unaligned"])
def test_kde_sample(model, name):
    """Plain and log-space (kde_ht) KDE samples, bit for bit, against the
    JAX sample as the batch programs run it (jitted: XLA contracts
    data + bw * z into one fused multiply-add)."""
    import jax

    _, _, jt, tt = model
    rs = np.random.default_rng(2)
    u = rs.random(200_000).astype(np.float32)
    z = rs.normal(size=200_000).astype(np.float32)
    kd = getattr(jt, name)
    _eq(jax.jit(lambda a, b: kd.sample(a, b))(jnp.asarray(u), jnp.asarray(z)),
        getattr(tt, name).sample(torch.from_numpy(u), torch.from_numpy(z)), name)


def test_kde_pickles_round_trip(tmp_path):
    data = np.random.default_rng(3).normal(1000, 300, 257)
    # sklearn/joblib pickle written by the JAX package -> the port's loader
    jkde.save_kde(str(tmp_path / "a.pkl"), data, 12.5)
    m = tkde.load_kde(str(tmp_path / "a.pkl"), log_transform=True)
    np.testing.assert_array_equal(m.data[:, 0], data)
    assert m.bandwidth == 12.5 and m.log_transform
    # the port's plain pickle -> the JAX package's loader
    tkde.save_kde(str(tmp_path / "b.pkl"), data, 7.25)
    m2 = jkde.load_kde(str(tmp_path / "b.pkl"))
    np.testing.assert_array_equal(m2.data[:, 0], data)
    assert m2.bandwidth == 7.25
    # a scikit-learn 0.22.1 pickle (classes that no longer import)
    a, b = jkde.load_kde(FIXTURE_0221), tkde.load_kde(FIXTURE_0221)
    np.testing.assert_array_equal(a.data, b.data)
    assert a.bandwidth == b.bandwidth


def test_qual_breakpoints_equal_jax(model):
    prefix, jprof, jt, _ = model
    br, vl = jtab.build_qual_breakpoints(jprof.base_quals, jtab.QualDevice.CLASSES)
    from nanosim_tpu_torch.ops import tables as ttab

    br2, vl2 = ttab._build_qual_breakpoints_compute(jprof.base_quals, ttab.QualDevice.CLASSES)
    _eq(br, br2)
    _eq(vl, vl2)
