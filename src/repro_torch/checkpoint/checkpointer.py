"""Durable distributed checkpointer following the paper's two guidelines.

1. **One blocking persist per checkpoint** (the fence lower bound): shard
   files stream out asynchronously (optionally on a background thread --
   compute/IO overlap); the only blocking barrier is the final commit-record
   fsync.  Shard fsyncs are issued before the commit (they are the
   "asynchronous flushes"; the commit is the SFENCE).
2. **Zero post-flush accesses**: nothing written is ever read back on the
   fast path -- no readback-verify, no manifest read-modify-write.  Recovery
   is an UnlinkedQ-style *directory scan*: every ``step_XXXX`` directory is a
   node in a designated area, the COMMIT record is its ``linked`` flag, the
   step number its ``index``; restore = the max-index committed entry,
   torn/uncommitted entries are ignored (and garbage-collected).

Works per-host on its own parameter shards: each host writes
``shard_{host}.npz`` independently; host 0 writes the commit record once all
shard writes have landed -- on a real cluster that "all landed" signal is a
cross-host barrier, here it is sequential completion in the save worker.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import struct
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

PyTree = Any


def _flatten(tree: PyTree, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> PyTree:
    root: Dict[str, Any] = {}
    for path, v in flat.items():
        parts = path.split("/")
        cur = root
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    def fix(node):
        if isinstance(node, dict):
            keys = list(node.keys())
            if keys and all(re.fullmatch(r"\d+", k) for k in keys):
                return [fix(node[str(i)]) for i in range(len(keys))]
            return {k: fix(v) for k, v in node.items()}
        return node
    return fix(root)


class DurableCheckpointer:
    def __init__(self, directory: str, keep: int = 2,
                 background: bool = True):
        self.dir = directory
        self.keep = keep
        self.background = background
        os.makedirs(directory, exist_ok=True)
        self.commit_fences = 0
        self._inflight: Optional[threading.Thread] = None

    # ----------------------------------------------------------------- save
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def _write_shard(self, step: int, shard_id: int, tree: PyTree) -> None:
        d = self._step_dir(step)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"shard_{shard_id}.npz")
        flat = _flatten(tree)
        with open(path, "wb") as f:
            np.savez(f, **flat)
            f.flush()
            os.fsync(f.fileno())     # asynchronous-flush analogue (per shard)

    def save(self, step: int, shards: Dict[int, PyTree],
             meta: Optional[dict] = None) -> None:
        """Write all shards, then ONE blocking commit."""
        if self._inflight is not None:
            self._inflight.join()    # previous async save must land first
            self._inflight = None

        def work():
            for sid, tree in shards.items():
                self._write_shard(step, sid, tree)
            self._commit(step, n_shards=len(shards), meta=meta or {})
            self._gc()

        if self.background:
            self._inflight = threading.Thread(target=work, daemon=True)
            self._inflight.start()
        else:
            work()

    def wait(self) -> None:
        if self._inflight is not None:
            self._inflight.join()
            self._inflight = None

    def _commit(self, step: int, n_shards: int, meta: dict) -> None:
        """The single blocking persist (the checkpoint's SFENCE)."""
        d = self._step_dir(step)
        body = json.dumps({"step": step, "n_shards": n_shards,
                           "meta": meta}).encode()
        crc = zlib.crc32(body) & 0xFFFFFFFF
        path = os.path.join(d, "COMMIT")
        with open(path, "wb") as f:
            f.write(struct.pack("<I", crc) + body)
            f.flush()
            os.fsync(f.fileno())
        # fsync the parent so the directory entry itself is durable
        fd = os.open(self.dir, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        self.commit_fences += 1

    # ------------------------------------------------------------- recovery
    @staticmethod
    def _read_commit(path: str) -> Optional[dict]:
        try:
            with open(path, "rb") as f:
                raw = f.read()
            crc = struct.unpack("<I", raw[:4])[0]
            body = raw[4:]
            if (zlib.crc32(body) & 0xFFFFFFFF) != crc:
                return None
            return json.loads(body)
        except (OSError, ValueError, struct.error):
            return None

    def scan(self) -> List[Tuple[int, dict]]:
        """Designated-area scan: committed (step, meta) entries, ascending."""
        out = []
        for name in sorted(os.listdir(self.dir)):
            m = re.fullmatch(r"step_(\d+)", name)
            if not m:
                continue
            commit = self._read_commit(
                os.path.join(self.dir, name, "COMMIT"))
            if commit is not None:
                out.append((int(m.group(1)), commit))
        return out

    def restore_latest(self) -> Optional[Tuple[int, Dict[int, PyTree], dict]]:
        """Max-index committed checkpoint; torn/uncommitted ones ignored."""
        entries = self.scan()
        if not entries:
            return None
        step, commit = entries[-1]
        d = self._step_dir(step)
        shards: Dict[int, PyTree] = {}
        for sid in range(commit["n_shards"]):
            with np.load(os.path.join(d, f"shard_{sid}.npz")) as z:
                shards[sid] = _unflatten({k: z[k] for k in z.files})
        return step, shards, commit.get("meta", {})

    def _gc(self) -> None:
        """Reclaim old committed entries + any uncommitted garbage older
        than the newest commit (crash leftovers == unlinked nodes)."""
        committed = [s for s, _ in self.scan()]
        if not committed:
            return
        newest = committed[-1]
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if not m:
                continue
            step = int(m.group(1))
            keep_set = set(committed[-self.keep:])
            if step in keep_set:
                continue
            if step < newest or step in committed:
                shutil.rmtree(os.path.join(self.dir, name),
                              ignore_errors=True)
