"""Master-less checkpointing with failover (paper C2), counterpart of
``repro.core.checkpoint``.

The paper's failure mode: TF designates ONE master worker to checkpoint;
if the master is revoked the whole job dies. Here no worker is special:

- every checkpoint is written *replicated* to ``replicas`` worker
  directories; a replica that fails does not fail the save unless every
  replica does,
- writes are atomic (a ``.tmp_`` directory, fsync'd, then ``os.replace``)
  and carry a content checksum, so a worker revoked mid-write can never
  corrupt the restore path,
- ``restore_latest`` scans all replicas newest-first, skips a replica
  whose manifest or checksum fails, and falls back replica by replica,
  then step by step,
- ``fast=True`` is the revocation-warning path (GCE gives 30 s): one
  replica, no garbage collection.

The training step (``TrainState.step``) is part of the payload, so a
restart loses at most one global batch — the paper's C3 bound.

The format is the port's own (the reference pickles a jax treedef). A
step directory holds ``state.bin``, the raw bytes of every tensor leaf
one after another, and ``manifest.json``: the tree's structure with its
ints, each leaf's dtype, shape and byte count, the step, the ``extra``
metadata and the checksum. The save streams the state leaf by leaf —
copy one leaf to the host, hash its bytes, write them — so host memory
holds one leaf at a time, never a serialised copy of the whole state;
bf16 leaves are hashed and written as their raw bytes. The checksum is a
SHA-256 over the structure and, per leaf, its dtype, its shape and the
SHA-256 of its bytes' 64 MiB pieces, which a thread pool hashes while the
leaf is written. ``restore_latest`` reads the leaves back onto the device
the caller names, one at a time, as fresh tensors.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.train.step import TrainState

MANIFEST = "manifest.json"
PAYLOAD = "state.bin"
HASH_PIECE = 64 << 20           # bytes per SHA-256 piece of a leaf
_DTYPES = {str(d): d for d in (
    torch.float64, torch.float32, torch.bfloat16, torch.float16,
    torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
    torch.bool)}


# ---------------------------------------------------------------------------
# The tree's structure, as JSON
# ---------------------------------------------------------------------------

def _skeleton(obj: Any, leaves: List[torch.Tensor]) -> Any:
    """JSON structure of ``obj``; its tensors are appended to ``leaves``
    and stand as their index."""
    if isinstance(obj, TrainState):
        return {"train_state": {k: _skeleton(getattr(obj, k), leaves)
                                for k in ("params", "opt", "step")}}
    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        return {"tensor": len(leaves) - 1}
    if isinstance(obj, dict):
        if not all(isinstance(k, str) for k in obj):
            raise TypeError("checkpoint trees need str dict keys")
        return {"dict": {k: _skeleton(v, leaves) for k, v in obj.items()}}
    if isinstance(obj, list):
        return {"list": [_skeleton(v, leaves) for v in obj]}
    if isinstance(obj, bool):
        return {"bool": obj}
    if isinstance(obj, int):
        return {"int": obj}
    if isinstance(obj, float):
        return {"float": obj}
    if obj is None:
        return {"none": None}
    raise TypeError(f"cannot checkpoint a {type(obj).__name__}")


def _rebuild(skel: Any, leaves: List[torch.Tensor]) -> Any:
    (kind, val), = skel.items()
    if kind == "train_state":
        return TrainState(**{k: _rebuild(v, leaves) for k, v in val.items()})
    if kind == "tensor":
        return leaves[val]
    if kind == "dict":
        return {k: _rebuild(v, leaves) for k, v in val.items()}
    if kind == "list":
        return [_rebuild(v, leaves) for v in val]
    if kind in ("bool", "int", "float", "none"):
        return val
    raise ValueError(f"unknown checkpoint node {kind!r}")


def _leaf_digest(pool: concurrent.futures.Executor, buf: np.ndarray):
    """A future-like list of the SHA-256 digests of ``buf``'s pieces."""
    return [pool.submit(lambda p: hashlib.sha256(p).digest(),
                        buf[i:i + HASH_PIECE])
            for i in range(0, max(buf.nbytes, 1), HASH_PIECE)]


def _digest_update(h, dtype: str, shape, pieces) -> None:
    h.update(f"{dtype}{tuple(shape)}".encode())
    h.update(hashlib.sha256(b"".join(f.result() for f in pieces)).digest())


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    """The leaf's raw bytes as a flat uint8 array on the host."""
    host = t.detach().to("cpu").contiguous()
    return host.reshape(-1).view(torch.uint8).numpy()


# ---------------------------------------------------------------------------
# One replica's write
# ---------------------------------------------------------------------------

class _ReplicaWriter:
    """The ``.tmp_`` directory of one replica's write, published by an
    atomic rename. ``fail_after`` is the test hook: raise once that many
    bytes of the payload are written (a revocation mid-write)."""

    def __init__(self, rdir: str, fail_after: Optional[int]):
        self.rdir = rdir
        self.fail_after = fail_after
        self.tmp = tempfile.mkdtemp(dir=rdir, prefix=".tmp_")
        try:
            self.f = open(os.path.join(self.tmp, PAYLOAD), "wb")
        except OSError:
            shutil.rmtree(self.tmp, ignore_errors=True)
            raise
        self.written = 0

    def write(self, buf: np.ndarray) -> None:
        if (self.fail_after is not None
                and self.written + buf.nbytes > self.fail_after):
            self.f.write(buf[:self.fail_after - self.written])
            self.f.flush()
            raise RuntimeError("simulated revocation mid-write")
        self.f.write(buf)
        self.written += buf.nbytes

    def publish(self, sdir: str, meta: Dict[str, Any]) -> None:
        if os.path.isdir(sdir):
            # this replica already holds the step (a periodic save, then
            # the warning's fast save of the same step): keep that copy
            self.abort()
            return
        self.f.flush()
        os.fsync(self.f.fileno())
        self.f.close()
        with open(os.path.join(self.tmp, MANIFEST), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(self.tmp, sdir)               # atomic publish
        fd = os.open(self.rdir, os.O_RDONLY)     # make the rename durable
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def abort(self) -> None:
        self.f.close()
        shutil.rmtree(self.tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# The manager
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CheckpointManager:
    base_dir: str
    replicas: int = 2            # how many worker dirs hold full copies
    keep: int = 3                # retained steps per replica

    # test hook: raise after writing N bytes to simulate mid-write revocation
    fail_after_bytes: Optional[int] = None
    # the last save: step, replicas written, payload bytes, seconds
    last_save: Optional[Dict[str, Any]] = dataclasses.field(
        default=None, init=False, repr=False)

    def _replica_dir(self, r: int) -> str:
        d = os.path.join(self.base_dir, f"worker_{r}")
        os.makedirs(d, exist_ok=True)
        return d

    def _open(self, rdir: str) -> _ReplicaWriter:
        return _ReplicaWriter(rdir, self.fail_after_bytes)

    # -- write ------------------------------------------------------------
    def save(self, step: int, state: Any, *, extra: Optional[Dict] = None,
             fast: bool = False) -> int:
        """Write a checkpoint; returns the number of replicas written.

        ``state`` is a ``TrainState`` or a tree of dicts, lists, tensors
        and Python scalars. ``fast=True`` is the 30-second
        revocation-warning path: one replica, no cleanup.
        """
        t0 = time.monotonic()
        leaves: List[torch.Tensor] = []
        tree = _skeleton(state, leaves)
        h = hashlib.sha256(json.dumps(tree, sort_keys=True).encode())
        writers: List[_ReplicaWriter] = []
        first_err: Optional[BaseException] = None
        for r in range(1 if fast else self.replicas):
            try:
                writers.append(self._open(self._replica_dir(r)))
            except OSError as e:           # a replica dying mustn't kill save
                first_err = first_err or e
        index, nbytes = [], 0
        try:
            with concurrent.futures.ThreadPoolExecutor(
                    max(1, min(8, os.cpu_count() or 1))) as pool:
                for t in leaves:
                    if not writers:
                        break
                    buf = _host_bytes(t)
                    pieces = _leaf_digest(pool, buf)
                    for w in list(writers):
                        try:
                            w.write(buf)
                        except (OSError, RuntimeError) as e:
                            w.abort()
                            writers.remove(w)
                            first_err = first_err or e
                    _digest_update(h, str(t.dtype), t.shape, pieces)
                    index.append({"dtype": str(t.dtype),
                                  "shape": list(t.shape),
                                  "nbytes": buf.nbytes})
                    nbytes += buf.nbytes
                    del buf
            meta = {"step": int(step), "digest": h.hexdigest(),
                    "time": time.time(), "extra": extra or {}, "fast": fast,
                    "tree": tree, "leaves": index}
            sdir_name = f"step_{int(step):010d}"
            written = 0
            while writers:
                w = writers.pop(0)
                try:
                    w.publish(os.path.join(w.rdir, sdir_name), meta)
                    written += 1
                except OSError as e:
                    w.abort()
                    first_err = first_err or e
        finally:
            for w in writers:                  # left only by an exception
                w.abort()
        if written == 0:
            raise first_err
        if not fast:
            self._gc()
        self.last_save = {"step": int(step), "replicas": written,
                          "bytes": nbytes, "seconds": time.monotonic() - t0}
        return written

    def _gc(self) -> None:
        for r in range(self.replicas):
            rdir = self._replica_dir(r)
            steps = sorted(d for d in os.listdir(rdir)
                           if d.startswith("step_"))
            for d in steps[:-self.keep]:
                shutil.rmtree(os.path.join(rdir, d), ignore_errors=True)

    # -- read -------------------------------------------------------------
    def _candidates(self) -> List[Tuple[int, str]]:
        out = []
        if not os.path.isdir(self.base_dir):
            return out
        for r in os.listdir(self.base_dir):
            rdir = os.path.join(self.base_dir, r)
            if not os.path.isdir(rdir) or not r.startswith("worker_"):
                continue
            for d in os.listdir(rdir):
                if d.startswith("step_"):
                    out.append((int(d.split("_")[1]), os.path.join(rdir, d)))
        return sorted(out, reverse=True)

    def _load(self, sdir: str, device: Optional[torch.device]
              ) -> Optional[Tuple[int, Any, Dict]]:
        """The checkpoint in ``sdir`` with its leaves on ``device`` (None:
        verify only), or None if its manifest or checksum fails."""
        with open(os.path.join(sdir, MANIFEST)) as f:
            meta = json.load(f)
        h = hashlib.sha256(json.dumps(meta["tree"], sort_keys=True).encode())
        leaves: List[torch.Tensor] = []
        with open(os.path.join(sdir, PAYLOAD), "rb") as f, \
                concurrent.futures.ThreadPoolExecutor(
                    max(1, min(8, os.cpu_count() or 1))) as pool:
            for rec in meta["leaves"]:
                dtype, shape = _DTYPES[rec["dtype"]], tuple(rec["shape"])
                nbytes = int(rec["nbytes"])
                if nbytes != dtype.itemsize * int(np.prod(shape)):
                    raise ValueError(f"leaf of {nbytes} bytes cannot be "
                                     f"{rec['dtype']} {shape}")
                buf = np.empty(nbytes, np.uint8)
                if f.readinto(memoryview(buf)) != buf.nbytes:
                    return None                       # torn payload
                pieces = _leaf_digest(pool, buf)
                if device is not None:
                    t = torch.from_numpy(buf).view(dtype).reshape(shape)
                    leaves.append(t.to(device))
                _digest_update(h, rec["dtype"], shape, pieces)
            if f.read(1):
                return None                           # trailing bytes
        if h.hexdigest() != meta["digest"]:
            return None                               # corrupted replica
        tree = _rebuild(meta["tree"], leaves) if device is not None else None
        return meta["step"], tree, meta.get("extra", {})

    def restore_latest(self, device="cuda"
                       ) -> Optional[Tuple[int, Any, Dict]]:
        """(step, state, extra) of the newest valid checkpoint across all
        replicas, its tensors fresh on ``device``; else None."""
        device = resolve_device(device)
        for _step, sdir in self._candidates():
            try:
                got = self._load(sdir, device)
            except (OSError, KeyError, ValueError, TypeError):
                continue
            if got is not None:
                return got
        return None

    def latest_step(self) -> Optional[int]:
        """The step of the newest valid checkpoint, checked as
        ``restore_latest`` checks it but read into no device."""
        for step, sdir in self._candidates():
            try:
                got = self._load(sdir, None)
            except (OSError, KeyError, ValueError, TypeError):
                continue
            if got is not None:
                return got[0]
        return None
