"""The simulator core the PyTorch fleet executor runs on.

These modules are numpy-only copies of their ``repro.core`` originals, kept
line for line (``tests/test_torch_port_rules.py`` pins them), so the port
holds the same semantics without importing the JAX package: the NVRAM cost
engine, the memory models, the schedule compiler, the ssmem allocator, the
eight queue algorithms and the harness that the fleet's template, bail
replays and equivalence checks are built on.  The reference-engine oracle,
ONLL, the crash sweep and the trace subsystem are off the fleet path and
are not copied.
"""
from .memmodel import (MEMORY_MODELS, MemoryModel, OPTANE_CLWB, EADR,
                       CXL_MEM, get_memory_model)
from .contention import ContentionModel, LearnedRetryProfile, RetryProfile
from .nvram import (NVRAM, LINE_WORDS, N_EV, CrashChoices, EngineSnapshot,
                    Stats, ThreadCrashed)
from .opsched import (FastPathExecutor, OpSchedule, QueueSchedules,
                      ScheduleError, compile_schedule)
from .scheduler import ClockScheduler, Scheduler
from .ssmem import SSMem, VolatileAlloc
from .queue_base import NULL, QueueAlgorithm
from .harness import ALL_QUEUES, DURABLE_QUEUES, QueueHarness

__all__ = [
    "MEMORY_MODELS", "MemoryModel", "OPTANE_CLWB", "EADR", "CXL_MEM",
    "get_memory_model", "ContentionModel", "LearnedRetryProfile",
    "RetryProfile", "NVRAM", "LINE_WORDS", "N_EV", "CrashChoices",
    "EngineSnapshot", "Stats", "ThreadCrashed", "FastPathExecutor",
    "OpSchedule", "QueueSchedules", "ScheduleError", "compile_schedule",
    "ClockScheduler", "Scheduler", "SSMem", "VolatileAlloc", "NULL",
    "QueueAlgorithm", "ALL_QUEUES", "DURABLE_QUEUES", "QueueHarness",
]
