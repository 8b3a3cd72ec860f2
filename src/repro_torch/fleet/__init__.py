"""Fleet executor on PyTorch: 10k-1M independent queue instances stepped
as one array program on the card.

The counterpart of ``repro.fleet``:

* :mod:`repro_torch.fleet.lowering`, :mod:`repro_torch.fleet.state` and
  :mod:`repro_torch.fleet.stepper` -- verbatim copies of the reference's
  schedule lowering, template state and numpy reference stepper;
* :mod:`repro_torch.fleet.torchexec` -- the device-resident state and the
  ``cuda``/``torch`` backends around the chunk stepper
  (:mod:`repro_torch.kernels.fleet_step`);
* :mod:`repro_torch.fleet.runner` -- chunked execution with the bail/rejoin
  protocol and the ``check_instances`` gate.

Per-instance Stats (every counter and ``time_ns``) are bit-identical to
independent ``QueueHarness.run_batched`` runs, as in the reference.
``python -m repro_torch.fleet`` is the bench entry point.
"""
from .runner import (FleetConfig, FleetResult, build_fleet, check_instances,
                     fleet_kinds, run_fleet)
from .state import build_template

__all__ = [
    "FleetConfig", "FleetResult", "build_fleet", "build_template",
    "check_instances", "fleet_kinds", "run_fleet",
]
