"""End-to-end training driver: durable data queue -> train_step -> durable
checkpoints, with crash-restart.

The port of ``python -m repro.launch.train``: the data queue, the
per-worker cursor and the checkpointer (verbatim copies of the JAX
package's, numpy only) follow the one-fence / zero-post-flush-read
discipline; the cursor advances only when a checkpoint commits, so model
state and data state move together.

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \
      --steps 50 --ckpt-dir /tmp/run1 [--crash-at 23]
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu

The command line trains the reduced config (``--full`` for the full one)
on the card (``--device cuda``, the default) and raises where CUDA is
missing; ``--device cpu`` trains on the CPU.  ``--crash-at N`` ends the
process abruptly after step N (``os._exit(42)``), so that the same
command run again exercises real recovery.  :func:`train` takes the
``ModelConfig`` its caller built.

The checkpointer stores numpy arrays: fp32, int8 and int32 tensors as
they are, bf16 ones as their bit pattern in uint16, restored as bf16 bit
for bit (:func:`state_to_numpy`, :func:`state_from_numpy`).
"""
from __future__ import annotations

import argparse
import functools
import os
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from ..checkpoint import DurableCheckpointer
from ..configs import get_config, reduced_config
from ..data import DurableShardQueue, TokenSource
from ..models import init_params
from ..models.config import ModelConfig
from ..optim import init_opt_state
from ..optim.adamw import tree_leaves, tree_map
from ..serving.engine import resolve_device
from .steps import make_train_step, opt_config

DEFAULT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_train")


def state_to_numpy(tree):
    """A tree of tensors -> the same tree of numpy arrays on the host; a
    bf16 tensor becomes its bit pattern as uint16."""
    def one(t):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.uint16)
        return t.cpu().numpy()
    return tree_map(one, tree)


def state_from_numpy(tree, device, param_dtype: str):
    """The inverse of :func:`state_to_numpy`: uint16 arrays are bf16 bit
    patterns (only a bf16 model has them)."""
    def one(a):
        a = np.array(a, order="C")       # a 0-d array stays 0-d
        if a.dtype == np.uint16:
            if param_dtype != "bfloat16":
                raise ValueError(f"a bf16 leaf in a {param_dtype} model")
            return torch.from_numpy(a.view(np.int16)).view(
                torch.bfloat16).to(device)
        return torch.from_numpy(a).to(device)
    return tree_map(one, tree)


def train(cfg: ModelConfig, steps: int = 50, batch: int = 4,
          seq_len: int = 64, ckpt_dir: str = DEFAULT_DIR,
          ckpt_every: int = 10, crash_at: Optional[int] = None,
          device="cuda",
          log=functools.partial(print, flush=True)) -> dict:
    device = resolve_device(device)
    ocfg = opt_config(cfg)
    source = TokenSource(cfg.vocab, seq_len, batch)
    queue = DurableShardQueue(os.path.join(ckpt_dir, "data"))
    ckpt = DurableCheckpointer(os.path.join(ckpt_dir, "ckpt"),
                               background=False)

    # ---- recovery: model+optimizer state and the data cursor move together
    queue.recover()
    start_step = 0
    restored = ckpt.restore_latest()
    if restored is not None:
        start_step, shards, meta = restored
        params = state_from_numpy(shards[0]["params"], device,
                                  cfg.param_dtype)
        opt_state = state_from_numpy(shards[0]["opt"], device,
                                     cfg.param_dtype)
        log(f"[recovery] resumed from step {start_step} "
            f"(data cursor {meta.get('data_cursor')})")
    else:
        gen = torch.Generator(device=device).manual_seed(0)
        params = init_params(cfg, gen, device)
        opt_state = init_opt_state(ocfg, params)

    # keep the queue topped up (producer role; one fence per burst)
    have = len(queue._shards)
    if have < steps + 1:
        queue.enqueue_shards([{"shard": i} for i in range(have, steps + 8)])

    step_fn = make_train_step(cfg)
    losses, consumed, saves = [], [], []
    for step in range(start_step, steps):
        shard = queue.next_shard()
        assert shard is not None
        b = {k: torch.from_numpy(v).to(device)
             for k, v in source.batch_for(shard["shard"]).items()}
        if cfg.embed_stub:
            emb = np.asarray(np.random.RandomState(shard["shard"]).randn(
                batch, seq_len, cfg.d_model), np.float32) * 0.02
            b = {"embeds": torch.from_numpy(emb).to(
                device, getattr(torch, cfg.compute_dtype)),
                "labels": b["labels"]}
        params, opt_state, metrics = step_fn(params, opt_state, b)
        losses.append(float(metrics["loss"]))
        consumed.append(shard["shard"])
        if (step + 1) % ckpt_every == 0 or step + 1 == steps:
            t0 = time.perf_counter()
            tree = {"params": state_to_numpy(params),
                    "opt": state_to_numpy(opt_state)}
            ckpt.save(step + 1, {0: tree},
                      meta={"data_cursor": shard["_queue_index"] + 1,
                            "arch": cfg.name})
            ckpt.wait()
            saves.append({"step": step + 1,
                          "seconds": time.perf_counter() - t0,
                          "bytes": sum(a.nbytes for a in
                                       tree_leaves(tree))})
            # data-consumption durability rides the checkpoint commit
            queue.commit_consumed(shard["_queue_index"])
            log(f"step {step + 1}: loss={losses[-1]:.4f} [checkpointed]")
        else:
            log(f"step {step + 1}: loss={losses[-1]:.4f}")
        if crash_at is not None and step + 1 >= crash_at:
            log(f"[crash injection] abrupt exit after step {step + 1}")
            sys.stdout.flush()
            os._exit(42)
    queue.close()
    return {"losses": losses, "consumed": consumed, "final_step": steps,
            "start_step": start_step, "params": params,
            "opt_state": opt_state, "saves": saves}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=DEFAULT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--crash-at", type=int, default=None)
    ap.add_argument("--full", action="store_true",
                    help="full-size config (cluster scale)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else reduced_config(args.arch)
    out = train(cfg, args.steps, args.batch, args.seq_len, args.ckpt_dir,
                args.ckpt_every, args.crash_at, device)
    print(f"done: {out['final_step']} steps, "
          f"loss {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f}")


if __name__ == "__main__":
    main()
