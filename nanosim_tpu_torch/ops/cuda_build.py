"""Build and load the package's CUDA kernels (csrc/*.cu).

Each source is compiled with nvcc for sm_90a into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds) in the
package's gitignored build directory, at first use, and loaded with ctypes.
Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def sources_of(src: str) -> list:
    """The source and every csrc/ header it includes with ``#include "..."``
    (followed through the headers): an edit to any of them rebuilds the
    library."""
    seen, todo = [], [src]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        with open(path) as f:
            for name in re.findall(r'^\s*#include\s+"([^"]+)"', f.read(), re.M):
                dep = os.path.join(CSRC_DIR, name)
                if os.path.exists(dep):
                    todo.append(dep)
    return seen


def sass_summary(lib_path: str) -> dict:
    """Instruction counts of every kernel in a built library, from
    ``cuobjdump -sass``: {demangled-ish kernel name: {"total": n, "LDS": n,
    "LDG": n, "BRA": n, ...}} with one entry per opcode stem.  Says how two
    template instances of one kernel differ in the code the compiler made
    (unrolling, loads) where no profiler can be run.  Empty when the
    toolkit's cuobjdump is not found."""
    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    res = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True, timeout=300)
    out, name = {}, None
    for line in res.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = {"total": 0}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\d\s+)?([A-Z][A-Z0-9_]*)", line)
        if m and name is not None:
            op = m.group(1)
            out[name]["total"] += 1
            out[name][op] = out[name].get(op, 0) + 1
    return out


class KernelLibrary:
    """One csrc/ source built into ``_build/lib<name>.so``.

    ``bind(lib)`` declares the C functions' argument and result types.
    ``build_log`` keeps nvcc's output (the ptxas register and shared-memory
    report) of the build this process made, if it made one."""

    def __init__(self, source: str, bind):
        self.src = os.path.join(CSRC_DIR, source)
        name = os.path.splitext(source)[0]
        self.path = os.path.join(BUILD_DIR, f"lib{name}.so")
        self.bind = bind
        self.build_log = ""
        self._lib = None

    def load(self) -> ctypes.CDLL:
        """Compile the source (if the library is missing or older than the
        source or a header it includes) and load it."""
        if self._lib is not None:
            return self._lib
        newest = max(os.path.getmtime(p) for p in sources_of(self.src))
        if not (os.path.exists(self.path) and os.path.getmtime(self.path) >= newest):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{self.path}.{os.getpid()}.tmp"
            cmd = [nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp, self.src]
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
            self.build_log = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n{self.build_log}")
            os.replace(tmp, self.path)
        lib = ctypes.CDLL(self.path)
        self.bind(lib)
        self._lib = lib
        return lib


_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def current_raw_stream(device_index: int) -> int:
    """The raw handle of PyTorch's current stream on card `device_index`, as
    an int for a ctypes launcher (without building a Stream object where
    this PyTorch has the direct getter)."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(device_index)
    return torch.cuda.current_stream(device_index).cuda_stream


def time_ms(fn, n: int) -> float:
    """ms per call of fn on the card: CUDA events around n calls after a
    warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n
