"""Step-atomic, async checkpointing (port of `repro.checkpoint.ckpt`),
in the reference's on-disk layout, so either package restores what the
other wrote.

Layout (one directory per step):
    <dir>/step_000000042/
        manifest.json     # {"step", "version": 1, "leaves": [{"path",
                          #   "shape", "dtype", "index"}, ...]}
        shard_00000.npz   # leaf i as array "a<i>"
        COMMIT            # written LAST -> step-atomic visibility

Leaves are numbered in the reference's flattening order (dict keys
sorted) and named by their '/'-joined key paths ("params/blocks/attn/wq",
"opt/mu/embed", "step"). A step is written under `<path>.tmp` and moved
into place with `os.replace` after COMMIT, so a crash mid-write leaves
nothing visible; `latest_step` sees only committed steps.

On one host there is no mesh: a save copies every tensor to the host
(from the card through page-locked memory, one wait for all leaves),
and a restore puts each leaf, in the dtype of the `like` tree's leaf,
onto the caller's device (card <-> CPU is this port's elastic restore).
The async manager copies to the host synchronously (so the train loop
may go on changing its tensors) and writes on a background thread, one
save in flight; `keep_last` committed steps are kept.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.optim.optimizers import tree_leaves

_TORCH_OF = {"float32": torch.float32, "float64": torch.float64,
             "int32": torch.int32, "int64": torch.int64,
             "bfloat16": torch.bfloat16, "float16": torch.float16,
             "int8": torch.int8, "bool": torch.bool}


def _unflatten(tree, values, prefix=""):
    """A tree of `tree`'s structure holding values[path] at each leaf."""
    if isinstance(tree, dict):
        return {k: _unflatten(v, values, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(t, values, f"{prefix}{i}/")
                          for i, t in enumerate(tree))
    return values[prefix[:-1]]


def _host_tree(tree) -> dict:
    """{path: host numpy array of its own} for every leaf (a copy, also of
    a CPU tensor; bfloat16, which numpy lacks, as float32). Card tensors
    are copied asynchronously into page-locked memory (torch's cached
    host allocator) and waited for once."""
    out, cuda = {}, set()
    for p, leaf in tree_leaves(tree, paths=True):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach()
            if t.is_cuda:
                cuda.add(t.device)
                out[p] = t.to("cpu", non_blocking=True)
            else:
                out[p] = t.to("cpu", copy=True)
        else:
            out[p] = np.array(leaf)
    for dev in cuda:
        torch.cuda.synchronize(dev)
    return {p: (t.float() if t.dtype == torch.bfloat16 else t).numpy()
            if isinstance(t, torch.Tensor) else t for p, t in out.items()}


def latest_step(directory: str) -> Optional[int]:
    """The newest committed step under `directory`, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(name.split("_")[1]) for name in os.listdir(directory)
             if name.startswith("step_") and os.path.exists(
                 os.path.join(directory, name, "COMMIT"))]
    return max(steps) if steps else None


def save_checkpoint(directory: str, step: int, tree: Any, *,
                    host_id: int = 0) -> str:
    """Write `tree` (nested dicts of tensors or numpy arrays) as step
    `step`: shard, manifest, then COMMIT, atomically. Returns the step's
    directory."""
    path = os.path.join(directory, f"step_{step:09d}")
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": [], "version": 1}
    arrays = {}
    for i, (p, arr) in enumerate(_host_tree(tree).items()):
        manifest["leaves"].append({"path": p, "shape": list(arr.shape),
                                   "dtype": str(arr.dtype), "index": i})
        arrays[f"a{i}"] = arr          # npz keys cannot hold '/'
    np.savez(os.path.join(tmp, f"shard_{host_id:05d}.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "COMMIT"), "w") as f:
        f.write(str(time.time()))
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path


def restore_checkpoint(directory: str, step: int, like: Any, *,
                       device=None) -> Any:
    """Step `step` in the structure of `like` (a tree of tensors, meta
    tensors included, or of numpy arrays): each leaf read from its path,
    cast to the like leaf's dtype and put on `device` (default: the like
    leaf's device, the CPU for a meta or numpy leaf). Only the leaves
    `like` names are read, so {"params": ...} restores a training
    state's parameters alone."""
    path = os.path.join(directory, f"step_{step:09d}")
    if not os.path.exists(os.path.join(path, "COMMIT")):
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    with open(os.path.join(path, "manifest.json")) as f:
        by_path = {m["path"]: m for m in json.load(f)["leaves"]}
    shards = [os.path.join(path, n) for n in sorted(os.listdir(path))
              if n.startswith("shard_") and n.endswith(".npz")]
    files = [np.load(s) for s in shards]
    try:
        values = {}
        for p, leaf in tree_leaves(like, paths=True):
            meta = by_path.get(p)
            if meta is None:
                raise KeyError(f"checkpoint missing leaf {p}")
            key = f"a{meta['index']}"
            arr = next(z[key] for z in files if key in z.files)
            t = torch.from_numpy(np.array(arr))
            if isinstance(leaf, torch.Tensor):
                dev = device or (leaf.device if leaf.device.type != "meta"
                                 else "cpu")
                values[p] = t.to(device=dev, dtype=leaf.dtype)
            else:
                dt = _TORCH_OF[str(np.asarray(leaf).dtype)]
                values[p] = t.to(device=device or "cpu", dtype=dt)
    finally:
        for z in files:
            z.close()
    return _unflatten(like, values)


class CheckpointManager:
    """Async, retention-managed checkpointing for the train loop."""

    def __init__(self, directory: str, keep_last: int = 3):
        self.directory = directory
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    def wait(self):
        """Join the save in flight; raise its error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree: Any):
        """Copy `tree` to the host now, write it on a background thread."""
        self.wait()                 # one in flight at a time
        host = _unflatten(tree, _host_tree(tree))

        def work():
            try:
                save_checkpoint(self.directory, step, host)
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save(self, step: int, tree: Any):
        self.wait()
        save_checkpoint(self.directory, step, tree)
        self._gc()

    def restore_latest(self, like: Any, *, device=None):
        """(step, tree) of the newest committed step, or (None, None)."""
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return step, restore_checkpoint(self.directory, step, like,
                                        device=device)

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.directory)
            if n.startswith("step_") and os.path.exists(
                os.path.join(self.directory, n, "COMMIT")))
        for s in steps[: -self.keep_last]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"),
                          ignore_errors=True)
