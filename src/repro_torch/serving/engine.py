"""Batched serving engine: durable request queue -> prefill+decode loop.

The PyTorch counterpart of ``repro.serving.engine``, with its quirks kept
so both return the same tokens for the same parameters: shorter prompts
are right-padded with token 0 and the pads are fed as real tokens; the
prompt is teacher-forced one token at a time through ``serve_step`` (no
separate prefill); one position ``t`` serves the whole batch; greedy
argmax takes the first maximum, as ``jnp.argmax`` does; each batch's
responses are committed under one fence.  Runs on the card by default;
the CPU runs it only when asked (``device="cpu"``), and asking for CUDA
where there is none raises.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..models import init_cache, init_params, serve_step
from ..models.config import ModelConfig
from .request_queue import DurableRequestQueue


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises for CUDA where there is none
    (no fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run on the CPU")
    return device


class ServeEngine:
    def __init__(self, cfg: ModelConfig, queue: DurableRequestQueue,
                 params=None, seed: int = 0, max_len: int = 64,
                 device="cuda"):
        self.cfg = cfg
        self.queue = queue
        self.max_len = max_len
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(cfg, gen, self.device)
        self.params = params
        self.steps = 0                  # serve_step calls so far

    @torch.inference_mode()
    def _greedy(self, prompts: np.ndarray, max_new: int) -> np.ndarray:
        B, P = prompts.shape
        if P + max_new - 1 > self.max_len:
            raise ValueError(f"prompt {P} + max_new {max_new} - 1 positions "
                             f"exceed the cache's max_len {self.max_len}")
        cache = init_cache(self.cfg, B, self.max_len, self.device)
        prompt = torch.as_tensor(prompts, dtype=torch.long,
                                 device=self.device)
        tok = prompt[:, 0:1]
        outs = []
        for t in range(P + max_new - 1):
            pos = torch.full((B,), t, dtype=torch.int32, device=self.device)
            logits, cache = serve_step(self.cfg, self.params, cache,
                                       {"tokens": tok}, pos)
            self.steps += 1
            nxt = torch.argmax(logits, dim=-1)[:, None]
            if t + 1 < P:
                tok = prompt[:, t + 1:t + 2]
            else:
                tok = nxt
                outs.append(nxt[:, 0])
        return torch.stack(outs, dim=1).cpu().numpy()   # (B, max_new)

    def serve_once(self, batch_size: int = 4, max_new: int = 8) -> List[dict]:
        batch = self.queue.take_batch(batch_size)
        if not batch:
            return []
        P = max(len(r["prompt"]) for r in batch)
        prompts = np.zeros((len(batch), P), np.int32)
        for i, r in enumerate(batch):
            p = np.asarray(r["prompt"], np.int32)
            prompts[i, :len(p)] = p
        gen = self._greedy(prompts, max_new)
        responses = [{"id": r["id"], "tokens": gen[i].tolist()}
                     for i, r in enumerate(batch)]
        self.queue.commit_responses(responses)   # ONE fence for the batch
        return responses

    def run(self, batch_size: int = 4, max_new: int = 8) -> int:
        n = 0
        while self.queue.pending_count():
            n += len(self.serve_once(batch_size, max_new))
        return n
