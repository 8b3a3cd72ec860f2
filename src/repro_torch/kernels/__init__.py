"""Kernels written by hand for Hopper, each beside its plain PyTorch
version.

Each module holds the plain version (what CPU tensors run, and the oracle
the kernel is held to on the card), a wrapper that launches the kernel for
CUDA tensors and keeps a ``launches`` count, and the build of the CUDA
source in ``src/repro_torch/csrc/``.  Ported so far: ``fleet_step`` (the
fleet's opcode chunk stepper).
"""
