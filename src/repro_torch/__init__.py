"""PyTorch/CUDA port of the durable-queues reproduction.

A second package beside the JAX reference ``repro``: it imports torch and
numpy, never jax and never ``repro``.  The numpy-only modules it needs
are kept as verbatim copies (``core/``, ``fleet/lowering.py``,
``fleet/state.py``, ``fleet/stepper.py``, ``models/config.py``,
``configs/``, ``persist/``, ``serving/request_queue.py``); the modules
that ran on the TPU
are rewritten for PyTorch, with each Pallas kernel replaced by a CUDA
kernel written by hand for Hopper (``csrc/``) beside a plain PyTorch
version of the same function.

Ported so far: the fleet executor (:mod:`repro_torch.fleet`) with its
opcode chunk stepper (:mod:`repro_torch.kernels.fleet_step`), and prefill
and serving for models of attention or mamba mixers with dense FFNs
(:mod:`repro_torch.models`, :mod:`repro_torch.serving`,
:mod:`repro_torch.launch`) with decode and flash attention kernels
(:mod:`repro_torch.kernels.decode_attention`,
:mod:`repro_torch.kernels.flash_attention`) and the selective scan
(:mod:`repro_torch.kernels.ssm_scan`).  Every TPU kernel of the JAX
package has its counterpart here.
"""
