"""``python -m repro_torch.fleet``: queue-ops/sec across a simulated user
fleet, on the port.

The counterpart of ``benchmarks/run.py fleet``: 10k-1M independent queue
instances (one per simulated user/tenant, one thread each) stepped as one
array program, by default through the CUDA chunk kernel on the card.
``--check N`` re-runs N sampled instances per cell on independent
``run_batched`` harnesses and requires bit-identical Stats; failures exit
1.  Each cell prints ``fleet/<model>/off/<queue>,<us_per_op>,...`` and a
backend-qualified headline cell ``fleet/<model>/off/<queue>/<backend>_
wall_us_per_op``.
"""
from __future__ import annotations

import argparse
import csv
import sys

from ..core.harness import ALL_QUEUES
from ..core.memmodel import MEMORY_MODELS
from .runner import BACKENDS, FleetConfig, check_instances, run_fleet

CSV_COLUMNS = [
    "queue", "model", "contention", "backend", "device", "instances",
    "ops_per_instance", "total_ops", "chunk", "bails", "residents",
    "build_s", "run_s", "fleet_mops_per_s", "sim_ns_per_op",
    "fences_per_op", "post_flush_per_op", "checked", "check_ok",
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.fleet",
        description="queue-ops/sec across a simulated user fleet, on the "
                    "PyTorch port")
    ap.add_argument("--instances", type=int, default=100_000)
    ap.add_argument("--ops", type=int, default=96,
                    help="plan steps per instance")
    ap.add_argument("--queues", default="DurableMSQ,OptUnlinkedQ,OptLinkedQ",
                    help=f"comma-separated, from {','.join(ALL_QUEUES)}")
    ap.add_argument("--models", default="optane-clwb",
                    help=f"comma-separated memory models "
                         f"({','.join(MEMORY_MODELS)})")
    ap.add_argument("--backend", choices=BACKENDS, default="cuda",
                    help="cuda (the chunk kernel; default), torch (its "
                         "plain PyTorch version) or numpy (the reference "
                         "stepper on the host)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the cuda and torch backends")
    ap.add_argument("--chunk", type=int, default=48,
                    help="plan steps per chunk (bail/rejoin granularity)")
    ap.add_argument("--batch", type=int, default=0,
                    help="instances per state batch (0 = the whole fleet)")
    ap.add_argument("--prefill", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check", type=int, default=0,
                    help="check this many sampled instances per cell "
                         "against independent run_batched harnesses")
    ap.add_argument("--out", default=None, help="CSV destination")
    args = ap.parse_args(argv)

    rows, failures = [], []
    print(f"# fleet: {args.instances} instances x {args.ops} ops "
          f"(backend {args.backend} on {args.device}, chunk {args.chunk})")
    print("name,us_per_call,derived")
    for model in args.models.split(","):
        for qname in args.queues.split(","):
            cfg = FleetConfig(
                queue=qname, model=model, instances=args.instances,
                ops=args.ops, prefill=args.prefill, seed=args.seed,
                chunk=args.chunk, backend=args.backend, device=args.device,
                batch=args.batch)
            res = run_fleet(cfg)
            agg = res.aggregate()
            total = res.total_ops
            sim_ns = agg.time_ns / total
            checked = check_ok = 0
            if args.check:
                checks = check_instances(res, sample=args.check)
                checked = len(checks)
                check_ok = sum(r["ok"] for r in checks)
                failures += [f"{qname}/{model}: instance {r['instance']} "
                             f"fleet Stats != run_batched Stats"
                             for r in checks if not r["ok"]]
            us = res.run_s * 1e6 / total
            rows.append({
                "queue": qname, "model": model, "contention": "off",
                "backend": res.backend, "device": res.device,
                "instances": args.instances, "ops_per_instance": args.ops,
                "total_ops": total, "chunk": args.chunk, "bails": res.bails,
                "residents": res.residents, "build_s": res.build_s,
                "run_s": res.run_s,
                "fleet_mops_per_s": res.ops_per_sec / 1e6,
                "sim_ns_per_op": sim_ns,
                "fences_per_op": agg.fences / total,
                "post_flush_per_op": agg.post_flush_accesses / total,
                "checked": checked, "check_ok": check_ok,
            })
            print(f"fleet/{model}/off/{qname},{us:.4f},"
                  f"mops={res.ops_per_sec / 1e6:.2f};"
                  f"sim_ns_per_op={sim_ns:.1f};"
                  f"fences_per_op={agg.fences / total:.2f};"
                  f"backend={res.backend};device={res.device};"
                  f"bails={res.bails};checked={check_ok}/{checked}")
            print(f"fleet/{model}/off/{qname}/{res.backend}_wall_us_per_op,"
                  f"{us:.4f}")
    if args.out:
        with open(args.out, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=CSV_COLUMNS)
            w.writeheader()
            w.writerows(rows)
        print(f"# wrote {len(rows)} rows to {args.out}")
    for msg in failures:
        print(f"# FLEET CHECK FAILURE: {msg}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
