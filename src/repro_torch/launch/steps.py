"""Step functions for the prefill and serve cells.

The PyTorch counterparts of ``make_prefill_step`` and ``make_serve_step``
in ``repro.launch.steps``.  The train step, the optimizer and
``input_specs`` come with the training slice.
"""
from __future__ import annotations

from typing import Callable

from ..models import forward, serve_step
from ..models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig, use_kernels: bool = True
                      ) -> Callable:
    def prefill_step(params, batch):
        return forward(cfg, params, batch, use_kernels)[:, -1]
    return prefill_step


def make_serve_step(cfg: ModelConfig, use_kernels: bool = True) -> Callable:
    def step(params, cache, batch):
        position = batch["position"]
        toks = {k: v for k, v in batch.items() if k != "position"}
        return serve_step(cfg, params, cache, toks, position, use_kernels)
    return step
