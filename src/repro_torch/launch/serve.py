"""Serving entry point: durable request queue + batched greedy decoding.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
      --requests 12 --dir /tmp/serve1
  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b

The port of ``python -m repro.launch.serve``, with its flags and its
traffic (4-token prompts from ``RandomState(0)``) on the reduced config.
It runs on the card (``--device cuda``, the default) and raises where
CUDA is missing; ``--device cpu`` serves on the CPU.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from ..configs import reduced_config
from ..serving import DurableRequestQueue, ServeEngine
from ..serving.engine import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--dir", default=os.path.join(tempfile.gettempdir(),
                                                  "repro_torch_serve"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = reduced_config(args.arch)
    q = DurableRequestQueue(args.dir)
    q.recover()
    rng = np.random.RandomState(0)
    reqs = [{"id": f"r{i}", "prompt": rng.randint(
        0, cfg.vocab, (4,)).tolist()} for i in range(args.requests)]
    q.submit(reqs)
    eng = ServeEngine(cfg, q, device=device)
    n = eng.run(batch_size=args.batch, max_new=args.max_new)
    print(f"served {n} requests on {device}; responses durable in "
          f"{args.dir}")


if __name__ == "__main__":
    main()
