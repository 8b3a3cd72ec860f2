"""PyTorch/CUDA port of the durable-queues reproduction.

A second package beside the JAX reference ``repro``: it imports torch and
numpy, never jax and never ``repro``.  The numpy-only simulator modules it
needs are kept as verbatim copies (``core/``, ``fleet/lowering.py``,
``fleet/state.py``, ``fleet/stepper.py``); the modules that ran on the TPU
are rewritten for PyTorch, with each Pallas kernel replaced by a CUDA
kernel written by hand for Hopper (``csrc/``) beside a plain PyTorch
version of the same function.

Ported so far: the fleet executor (:mod:`repro_torch.fleet`) and its
opcode chunk stepper (:mod:`repro_torch.kernels.fleet_step`).
"""
