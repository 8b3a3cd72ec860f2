"""Kernels written by hand for Hopper, each beside its plain PyTorch
version.

Each module holds the plain version (what CPU tensors run, and the oracle
the kernel is held to on the card) and a wrapper that launches the kernel
for CUDA tensors and keeps a ``launches`` count; :mod:`.build` compiles
the CUDA sources in ``src/repro_torch/csrc/`` and binds them.  The four:
``fleet_step`` (the fleet's opcode chunk stepper), ``decode_attention``
(split-K decode attention over a KV cache), ``flash_attention`` (causal /
non-causal attention forward) and ``ssm_scan`` (the mamba-1 selective
scan).
"""
