"""Crash-safe checkpointing of named trees of numpy arrays, the JAX
package's ``repro.checkpoint.manager`` on dicts instead of jax pytrees,
with the same layout on disk:

  * ``<directory>/step_{step:08d}/``: one ``<name>.npz`` per tree, keyed
    by the tree's path (dict keys and sequence indices joined by ``/``,
    as the JAX package's path flattening writes them), and
    ``manifest.json``, the commit record, written last;
  * atomicity: everything is written to ``step_XXXXXXXX.tmp/`` first and
    renamed; a crash mid-write never corrupts the latest checkpoint;
  * durability: every file and the containing directories are fsync'd
    around the rename (see :meth:`CheckpointManager._commit`), so a power
    loss after ``save`` returns can not roll back or tear the commit;
  * async save: file IO happens on a persistent writer thread fed by a
    bounded queue; the caller pays the host copy and the enqueue, with
    backpressure once ``QUEUE_DEPTH`` checkpoints are outstanding;
  * retention: keep the newest ``keep`` checkpoints;
  * sharded trees: a DTensor leaf is written whole (``full_tensor()``, a
    collective), as jax saves a sharded array, and ``restore(...,
    shardings=...)`` places each leaf on any mesh (the elastic-remesh hook:
    one file restores onto any mesh). Under an initialised process group of
    more than one rank the manager is collective: every rank calls ``save``
    and ``restore``, every rank gathers the same contents, rank 0 alone
    writes, and a barrier after the write (``save``, synchronous) or after
    the writer's queue is drained (``restore``) keeps a rank from reading a
    step that rank 0 has not committed.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor


def _flatten_with_paths(tree, prefix: str = "") -> dict:
    """{path: leaf} of a tree of dicts, lists and tuples (leaves: arrays or
    tensors); dict keys in sorted order, as jax's tree flattening yields
    them."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten_with_paths(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, leaf in enumerate(tree):
            out.update(_flatten_with_paths(leaf, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _collective() -> bool:
    """Whether this process is one rank of an initialised group of several."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def save_pytree(tree, path: str) -> None:
    """Write the leaves of ``tree`` to the npz ``path``, keyed by path."""
    np.savez(path, **{k: _to_host(v) for k, v in _flatten_with_paths(tree).items()})


def _load_leaf(arr: np.ndarray, leaf, shard):
    """``arr`` as its template leaf: a torch tensor template (``abstract_params``'
    meta tensors) gives a tensor of its dtype, another template with a dtype
    a numpy array of that dtype; with ``shard`` (a ``MeshPlacement``), a
    DTensor on its mesh, each rank keeping its own shard of the whole array
    it read."""
    if isinstance(leaf, torch.Tensor):
        value = torch.from_numpy(arr).to(leaf.dtype)
    else:
        value = arr.astype(leaf.dtype) if hasattr(leaf, "dtype") else arr
    if shard is None:
        return value
    t = value if isinstance(value, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(value))
    return distribute_tensor(t.to(shard.mesh.device_type), shard.mesh, shard.placements,
                             src_data_rank=None)


def load_pytree(template, path: str, shardings=None):
    """Restore into the structure of ``template`` (numpy arrays, or tensors:
    ``abstract_params``' meta tensors will do); each leaf takes its template
    leaf's dtype when it has one. ``shardings``: an optional tree of the
    same structure whose leaves are ``MeshPlacement`` values
    (``repro_torch.models.param.shardings``): each leaf then comes back as
    a DTensor on that mesh, whatever mesh it was saved from."""
    with np.load(path) as data:
        def walk(tree, shard, prefix=""):
            if isinstance(tree, dict):
                return {k: walk(v, None if shard is None else shard[k], f"{prefix}{k}/")
                        for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(walk(v, None if shard is None else shard[i], f"{prefix}{i}/")
                                  for i, v in enumerate(tree))
            return _load_leaf(data[prefix[:-1]], tree, shard)

        return walk(template, shardings)


def _fsync_path(path: str) -> None:
    """fsync a file or directory by path (directories need O_RDONLY)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointManager:
    #: Bound on queued-but-unwritten async checkpoints. Each queued item
    #: holds a full host copy of the state, so the bound caps memory;
    #: a producer outrunning the writer blocks in ``save`` (backpressure)
    #: instead of accumulating snapshots without limit.
    QUEUE_DEPTH = 4

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        os.makedirs(directory, exist_ok=True)
        self._queue: Optional[queue.Queue] = None
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------- save

    def save(self, step: int, state: dict[str, Any], metadata: Optional[dict] = None):
        """state: name -> tree of arrays or tensors. Blocks only for the
        device-to-host copy of tensors (numpy leaves are taken as they are,
        not copied: the caller must not change them until the write lands).

        Async saves hand the host copy to a persistent writer thread via a
        bounded queue; the caller never joins the in-flight write, so its
        cost is the device-to-host copy plus an enqueue.
        """
        host_state = {name: _map_leaves(_to_host, tree) for name, tree in state.items()}
        meta = dict(metadata or {})
        meta.update({"step": step, "time": time.time(), "trees": sorted(host_state)})
        collective = _collective()
        if not collective or dist.get_rank() == 0:  # rank 0 writes what every rank gathered
            if self.async_save:
                self._ensure_worker()
                self._queue.put((step, host_state, meta))
            else:
                self._write(step, host_state, meta)
        if collective and not self.async_save:
            dist.barrier()

    def _ensure_worker(self):
        if self._worker is None:
            self._queue = queue.Queue(maxsize=self.QUEUE_DEPTH)
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    def _drain(self):
        # The writer outlives a failed write: had it died, the saves queued
        # behind that write would never be marked done and wait() would
        # block forever. The first failure is kept for wait() to raise.
        while True:
            item = self._queue.get()
            try:
                self._write(*item)
            except BaseException as err:  # noqa: BLE001 (raised again by wait())
                if self._error is None:
                    self._error = err
            finally:
                self._queue.task_done()

    def _write(self, step: int, host_state, meta):
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for name, tree in host_state.items():
            save_pytree(tree, os.path.join(tmp, f"{name}.npz"))
        # manifest last: its presence inside the dir marks completeness
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        self._commit(tmp, final)
        self._gc()

    def _commit(self, tmp: str, final: str) -> None:
        """Crash-durable publish of a fully written ``tmp`` dir.

        ``os.rename`` alone is *atomic* but not *durable*: the data
        blocks, the tmp-dir entries, and the parent-dir rename can all
        still sit in the page cache when power is lost, leaving a
        renamed dir with torn npz payloads. Order of operations:
        fsync every file in ``tmp`` (payload hits disk), fsync ``tmp``
        itself (its directory entries hit disk), rename, then fsync the
        parent so the rename is journaled. Tests inject a crash here
        (:func:`repro_torch.testing.faultline.kill_mid_snapshot`) to prove
        a torn commit is never visible as the latest step."""
        for name in os.listdir(tmp):
            _fsync_path(os.path.join(tmp, name))
        _fsync_path(tmp)
        os.rename(tmp, final)
        _fsync_path(self.directory)

    def wait(self):
        """Block until every queued async write is committed or has failed,
        then raise the first failure of the writer since the last wait()
        (a write that raised is not on disk: the previous step stays the
        latest)."""
        if self._queue is not None:
            self._queue.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)

    # ---------------------------------------------------------- restore

    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if os.path.exists(os.path.join(self.directory, d, "manifest.json")):
                    out.append(int(d[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, templates: dict[str, Any], step: Optional[int] = None,
                shardings: Optional[dict[str, Any]] = None):
        """Returns (step, {name: tree}) or (None, None) if empty; a tree of
        ``templates`` that has an entry in ``shardings`` comes back placed on
        its mesh (:func:`load_pytree`)."""
        self.wait()
        if _collective():
            dist.barrier()
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        base = os.path.join(self.directory, f"step_{step:08d}")
        out = {}
        for name, tmpl in templates.items():
            shard = (shardings or {}).get(name)
            out[name] = load_pytree(tmpl, os.path.join(base, f"{name}.npz"), shard)
        return step, out
