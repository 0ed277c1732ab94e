"""nanosim_tpu_torch — the nanopore read simulator in PyTorch, for CUDA cards.

A port of the JAX package (the reference it is held against, byte for byte,
for a fixed seed and batch size).  Plain tensor code is PyTorch; the
error-state walks run as hand-written CUDA kernels for Hopper
(csrc/walk.cu).  It imports neither JAX nor the JAX package: the host-only
modules it needs (profiles, FASTA I/O, the native emitter bridge, the
reconstruction spec, the characterization stage) are its own copies.

Entry points run on the card unless the caller asks for the CPU
(`device="cpu"`), where the kernels' plain PyTorch versions run instead.
"""

__version__ = "0.1.0"
