"""Build and load the package's CUDA kernels (csrc/*.cu).

Each source is compiled with nvcc for sm_90a into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds) in the
package's gitignored build directory, at first use, and loaded with ctypes.
Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

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
        """Compile the source (if the library is missing or older than it)
        and load it."""
        if self._lib is not None:
            return self._lib
        if not (os.path.exists(self.path)
                and os.path.getmtime(self.path) >= os.path.getmtime(self.src)):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{self.path}.{os.getpid()}.tmp"
            cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, self.src]
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
            self.build_log = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n{self.build_log}")
            os.replace(tmp, self.path)
        lib = ctypes.CDLL(self.path)
        self.bind(lib)
        self._lib = lib
        return lib
