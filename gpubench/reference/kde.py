"""Gaussian-KDE length models (`*_aligned_region.pkl`, `*_ht_length.pkl`, ...).

The reference persists sklearn ``KernelDensity`` objects with joblib
(head_align_tail_dist.py:244-278) and samples them with ``kde.sample(n)``
(simulator.py:234-241).  For a Gaussian kernel that sampling is exactly

    x = data[i] + N(0, bandwidth),   i ~ U{0..n-1}

so the only state we need on device is the fitted data matrix and the
bandwidth.  :func:`load_kde` extracts those from any sklearn/joblib pickle —
including old-version pickles whose class definitions no longer import — via a
tolerant unpickler that records constructor/setstate payloads instead of
executing sklearn internals.

Neither sklearn nor joblib is needed: the loader is a subclass of the
pure-Python ``pickle._Unpickler`` that reads joblib's inlined array payloads
itself, and :func:`save_kde` writes a plain pickle of
``{"tree_": {"data": ndarray}, "bandwidth": bw}``, which this loader and the
tolerant path of sklearn-era loaders both read.
"""

from __future__ import annotations

import dataclasses
import pickle

import numpy as np


@dataclasses.dataclass
class KdeModel:
    """Sampling parameters of a fitted Gaussian KDE."""

    data: np.ndarray  # [n, d] float64 fitted points
    bandwidth: float
    log_transform: bool = False  # sampled as 10**x - 1 (simulator.py:237-238)

    @property
    def n(self) -> int:
        return self.data.shape[0]

    @property
    def dim(self) -> int:
        return self.data.shape[1]

    def sample(self, rng: np.random.Generator, num: int) -> np.ndarray:
        """Host-side sampling mirroring sklearn KernelDensity.sample."""
        i = (rng.uniform(0, 1, num) * self.n).astype(np.int64)
        out = self.data[i] + rng.normal(0.0, self.bandwidth, (num, self.dim))
        if self.log_transform:
            out = np.power(10.0, out) - 1
        return out


class _Opaque:
    """Base for placeholder classes standing in for classes we won't import."""

    _qualname = "?"
    _args = ()
    _kwargs: dict = {}
    _state = None

    def __init__(self, *args, **kwargs):
        self._args = args
        self._kwargs = kwargs

    def __setstate__(self, state):
        self._state = state


def _make_opaque(qualname: str):
    cls = type("Opaque_" + qualname.rsplit(".", 1)[-1], (_Opaque,), {"_qualname": qualname})
    return cls


_SAFE_MODULE_ROOTS = ("numpy", "builtins", "collections", "copyreg", "_codecs")


def _tolerant_find_class(super_find, module, name):
    if module.split(".")[0] in _SAFE_MODULE_ROOTS:
        return super_find(module, name)
    return _make_opaque(f"{module}.{name}")


def _walk_for_arrays(obj, out, depth=0):
    """Collect every 2-D float ndarray reachable from an opaque pickle graph."""
    if depth > 8:
        return
    if isinstance(obj, np.ndarray):
        if obj.ndim == 2 and obj.dtype.kind == "f":
            out.append(obj)
        return
    if isinstance(obj, (list, tuple)):
        for x in obj:
            _walk_for_arrays(x, out, depth + 1)
    elif isinstance(obj, dict):
        for x in obj.values():
            _walk_for_arrays(x, out, depth + 1)
    elif isinstance(obj, _Opaque):
        _walk_for_arrays(obj._args, out, depth + 1)
        _walk_for_arrays(obj._kwargs, out, depth + 1)
        _walk_for_arrays(obj._state, out, depth + 1)
        _walk_for_arrays(dict(vars(obj)), out, depth + 1)


def _find_bandwidth(obj, depth=0):
    if depth > 6:
        return None
    if isinstance(obj, dict):
        for key in ("bandwidth_", "bandwidth"):
            if key in obj and isinstance(obj[key], (int, float)):
                return float(obj[key])
        for x in obj.values():
            bw = _find_bandwidth(x, depth + 1)
            if bw is not None:
                return bw
    elif isinstance(obj, _Opaque):
        for src in (obj._state, obj._kwargs, dict(vars(obj))):
            bw = _find_bandwidth(src, depth + 1)
            if bw is not None:
                return bw
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            bw = _find_bandwidth(x, depth + 1)
            if bw is not None:
                return bw
    return None


class _JoblibArrayWrapper:
    """Stand-in for joblib's ``NumpyArrayWrapper``: holds the array header
    (shape, order, dtype, alignment) whose raw bytes follow it in the file."""

    def __setstate__(self, state):
        self.__dict__.update(state)


_JOBLIB_WRAPPERS = ("NumpyArrayWrapper",)


class _TolerantUnpickler(pickle._Unpickler):
    """Pure-Python unpickler: numpy/stdlib classes load as themselves,
    joblib's array wrappers become :class:`_JoblibArrayWrapper` and are
    replaced by the array bytes that follow them in the stream (joblib's
    NumpyArrayWrapper.read_array layout), every other class becomes an opaque
    state holder."""

    def find_class(self, module, name):
        if module.split(".")[0] == "joblib":
            if name in _JOBLIB_WRAPPERS:
                return _JoblibArrayWrapper
            return _make_opaque(f"{module}.{name}")
        return _tolerant_find_class(super().find_class, module, name)

    def load_build(self):
        super().load_build()
        top = self.stack[-1]
        if isinstance(top, _JoblibArrayWrapper):
            self.stack[-1] = self._read_wrapped_array(top)

    dispatch = dict(pickle._Unpickler.dispatch)
    dispatch[pickle.BUILD[0]] = load_build

    def _read_wrapped_array(self, w):
        dtype = np.dtype(w.dtype)
        if dtype.hasobject:
            raise ValueError("object arrays are not supported in KDE pickles")
        if getattr(w, "numpy_array_alignment_bytes", None) is not None:
            pad = int.from_bytes(self.read(1), "little")
            if pad:
                self.read(pad)
        shape = tuple(int(x) for x in w.shape)
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        data = self.read(count * dtype.itemsize)
        arr = np.frombuffer(data, dtype=dtype, count=count).copy()
        if w.order == "F":
            arr = arr.reshape(shape[::-1]).transpose()
        else:
            arr = arr.reshape(shape)
        return arr.astype(arr.dtype.newbyteorder("="), copy=False)


def _load_tolerant(path: str) -> KdeModel:
    """Unpickle a KDE file without importing sklearn or joblib classes.

    Swaps every non-{numpy,stdlib} class for an opaque state holder, restores
    joblib's inlined ndarray payloads, then mines the object graph for the
    fitted data + bandwidth.  Handles pickles from sklearn versions whose
    module layout no longer imports (e.g. the 0.22-era models shipped with the
    reference).
    """
    with open(path, "rb") as f:
        obj = _TolerantUnpickler(f).load()
    arrays: list[np.ndarray] = []
    _walk_for_arrays(obj, arrays)
    if not arrays:
        raise ValueError(f"no fitted data arrays found in {path}")
    # The KD/Ball tree's first (and largest) 2-D float array is the data.
    data = max(arrays, key=lambda a: a.size)
    bw = _find_bandwidth(obj)
    if bw is None:
        raise ValueError(f"no bandwidth found in {path}")
    return KdeModel(data=np.asarray(data, dtype=np.float64), bandwidth=bw)


def load_kde(path: str, log_transform: bool = False) -> KdeModel:
    """Extract (data, bandwidth) from a pickled sklearn KernelDensity."""
    model = _load_tolerant(path)
    model.log_transform = log_transform
    return model


def save_kde(path: str, data: np.ndarray, bandwidth: float) -> None:
    """Persist the fitted state as a plain pickle (no sklearn needed)."""
    data = np.asarray(data, dtype=np.float64)
    if data.ndim == 1:
        data = data[:, None]
    with open(path, "wb") as f:
        pickle.dump({"tree_": {"data": data}, "bandwidth": float(bandwidth)}, f,
                    protocol=4)
