"""Step-atomic, async checkpointing with elastic restore (port of
`repro.checkpoint.ckpt`), in the reference's on-disk layout, so either
package restores what the other wrote.

Layout (one directory per step):
    <dir>/step_000000042/
        manifest.json     # {"step", "version": 1, "leaves": [{"path",
                          #   "shape", "dtype", "index"}, ...], "mesh"}
        shard_00000.npz   # leaf i as array "a<i>"
        COMMIT            # written LAST -> step-atomic visibility

Leaves are numbered in the reference's flattening order (dict keys
sorted) and named by their '/'-joined key paths ("params/blocks/attn/wq",
"opt/mu/embed", "step"). A step is written under `<path>.tmp` and moved
into place with `os.replace` after COMMIT, so a crash mid-write leaves
nothing visible; `latest_step` sees only committed steps. "mesh" is the
writer's mesh ({"shape", "axis_names"}), or null for a tree with no
DTensor; the reference's restore reads no key but "leaves".

A save copies every leaf to the host (from the card through page-locked
memory, one wait for all leaves). A DTensor leaf is written whole: every
rank of its mesh gathers it (`full_tensor()`, leaf by leaf in the same
order, so a save is collective), rank 0 alone writes, and every rank
waits on a barrier before the state may change: after the host copy (an
async save) or after the write (a synchronous one). A restore puts each
leaf, in the dtype of the `like` tree's leaf, onto the caller's device,
or, given a `mesh`, onto that mesh with the placements of `shardings`,
whatever mesh (or none) wrote it: every rank reads the whole leaf on the
host and moves only its own shard to the device (the elastic restore).
The async manager copies to the host synchronously (so the train loop
may go on changing its tensors) and writes on a background thread, one
save in flight; `keep_last` committed steps are kept. Restoring on
several ranks needs a directory that every rank reads (rank 0 writes
it).
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

from repro_torch.models.common import is_dtensor
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
    if isinstance(tree, (list, tuple)) and not _is_spec(tree):
        return type(tree)(_unflatten(t, values, f"{prefix}{i}/")
                          for i, t in enumerate(tree))
    return values[prefix[:-1]]


def _is_spec(x) -> bool:
    """A `launch.sharding.Spec` (shape, dtype, placements): a leaf."""
    return isinstance(x, tuple) and hasattr(x, "placements")


def _mesh_of(tree):
    """The mesh of the tree's DTensor leaves, or None (no DTensor)."""
    for leaf in tree_leaves(tree):
        if is_dtensor(leaf):
            return leaf.device_mesh
    return None


def _mesh_json(mesh):
    if mesh is None:
        return None
    return {"shape": list(mesh.shape),
            "axis_names": list(mesh.mesh_dim_names)}


def _writer(mesh) -> bool:
    """Whether this process writes a tree on `mesh`: rank 0 of the
    default group (every process, for a tree with no mesh)."""
    import torch.distributed as dist
    return mesh is None or dist.get_rank() == 0


def _barrier(mesh) -> None:
    if mesh is None:
        return
    import torch.distributed as dist
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _host_tree(tree) -> dict:
    """{path: host numpy array of its own} for every leaf (a copy, also of
    a CPU tensor; bfloat16, which numpy lacks, as float32). A DTensor is
    gathered whole first (collective: every rank of its mesh calls this
    on the same tree). Card tensors are copied asynchronously into
    page-locked memory (torch's cached host allocator) and waited for
    once."""
    out, cuda = {}, set()
    for p, leaf in tree_leaves(tree, paths=True):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach()
            if is_dtensor(t):
                t = t.full_tensor()
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


def _from_host(t: torch.Tensor, mesh, placements, dtype) -> torch.Tensor:
    """The whole host tensor `t` as a DTensor on `mesh` with `placements`,
    in `dtype`: this rank's shard is cut on the host (the chunks
    `distribute_tensor` cuts: ceil(n / ranks) a rank, the last ones short
    or empty; a dimension split on several mesh axes, major to minor) and
    only it is moved to the device."""
    from torch.distributed.tensor import DTensor
    local = t
    for i, pl in enumerate(placements):
        if pl.is_shard():
            d, n = pl.dim, mesh.size(i)
            size = local.shape[d]
            chunk = -(-size // n)
            start = min(mesh.get_local_rank(i) * chunk, size)
            local = local.narrow(d, start, min(chunk, size - start))
        elif not pl.is_replicate():
            raise ValueError(f"cannot restore a leaf as {pl}")
    local = local.to(device=_mesh_device(mesh), dtype=dtype,
                     copy=True).contiguous()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def latest_step(directory: str) -> Optional[int]:
    """The newest committed step under `directory`, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(name.split("_")[1]) for name in os.listdir(directory)
             if name.startswith("step_") and os.path.exists(
                 os.path.join(directory, name, "COMMIT"))]
    return max(steps) if steps else None


def _write(directory: str, step: int, arrays: dict, mesh_desc,
           host_id: int = 0) -> str:
    """Write {path: host array} as step `step`: shard, manifest, then
    COMMIT, atomically. Returns the step's directory."""
    path = os.path.join(directory, f"step_{step:09d}")
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": [], "version": 1,
                "mesh": mesh_desc}
    npz = {}
    for i, (p, arr) in enumerate(arrays.items()):
        manifest["leaves"].append({"path": p, "shape": list(arr.shape),
                                   "dtype": str(arr.dtype), "index": i})
        npz[f"a{i}"] = arr             # npz keys cannot hold '/'
    np.savez(os.path.join(tmp, f"shard_{host_id:05d}.npz"), **npz)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "COMMIT"), "w") as f:
        f.write(str(time.time()))
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path


def save_checkpoint(directory: str, step: int, tree: Any, *,
                    host_id: int = 0) -> str:
    """Write `tree` (nested dicts of tensors, DTensors or numpy arrays) as
    step `step`: shard, manifest, then COMMIT, atomically. Returns the
    step's directory. A tree on a mesh is saved by every rank of it
    together (rank 0 writes; every rank returns once it has)."""
    mesh = _mesh_of(tree)
    arrays = _host_tree(tree)
    path = os.path.join(directory, f"step_{step:09d}")
    if _writer(mesh):
        path = _write(directory, step, arrays, _mesh_json(mesh), host_id)
    _barrier(mesh)
    return path


def restore_checkpoint(directory: str, step: int, like: Any, *,
                       device=None, mesh=None, shardings=None) -> Any:
    """Step `step` in the structure of `like` (a tree of tensors, meta
    tensors included, of numpy arrays, or of `launch.sharding.Spec`s):
    each leaf read from its path and cast to the like leaf's dtype. With
    no `mesh`, it goes to `device` (default: the like leaf's device, the
    CPU for a meta, numpy or Spec leaf). With a `mesh`, each leaf becomes
    a DTensor on it with its placements in `shardings` (a tree of like's
    structure: a placements tuple or None, a plain tensor on the mesh's
    device, at each leaf; default: a Spec leaf's own placements), the
    mesh that wrote the step being any or none. Only the leaves `like`
    names are read, so {"params": ...} restores a training state's
    parameters alone."""
    path = os.path.join(directory, f"step_{step:09d}")
    if not os.path.exists(os.path.join(path, "COMMIT")):
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    with open(os.path.join(path, "manifest.json")) as f:
        by_path = {m["path"]: m for m in json.load(f)["leaves"]}
    shards = [os.path.join(path, n) for n in sorted(os.listdir(path))
              if n.startswith("shard_") and n.endswith(".npz")]
    leaves = tree_leaves(like, paths=True, leaf=_is_spec)
    placed = {} if shardings is None else dict(tree_leaves(
        shardings, paths=True, leaf=lambda x: x is None
        or isinstance(x, tuple)))
    files = [np.load(s) for s in shards]
    try:
        values = {}
        for p, leaf in leaves:
            meta = by_path.get(p)
            if meta is None:
                raise KeyError(f"checkpoint missing leaf {p}")
            key = f"a{meta['index']}"
            arr = next(z[key] for z in files if key in z.files)
            t = torch.from_numpy(arr if arr.flags.writeable
                                 else np.array(arr))
            if _is_spec(leaf):
                dt, dev = leaf.dtype, "cpu"
            elif isinstance(leaf, torch.Tensor):
                dt = leaf.dtype
                dev = leaf.device if leaf.device.type != "meta" else "cpu"
            else:
                dt, dev = _TORCH_OF[str(np.asarray(leaf).dtype)], "cpu"
            if mesh is None:
                values[p] = t.to(device=device or dev, dtype=dt)
                continue
            pl = placed[p] if p in placed else getattr(leaf, "placements",
                                                       None)
            values[p] = _from_host(t, mesh, pl, dt) if pl is not None \
                else t.to(device=_mesh_device(mesh), dtype=dt)
    finally:
        for z in files:
            z.close()
    return _unflatten(like, values)


class CheckpointManager:
    """Async, retention-managed checkpointing for the train loop. Under a
    mesh every rank makes the same calls: a save gathers collectively,
    and `wait` ends on a barrier, so a step rank 0 has committed is seen
    by every rank."""

    def __init__(self, directory: str, keep_last: int = 3):
        self.directory = directory
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._mesh = None           # the mesh of the last save
        os.makedirs(directory, exist_ok=True)

    def wait(self):
        """Join the save in flight; raise its error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        _barrier(self._mesh)
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree: Any):
        """Copy `tree` to the host now (gathered, under a mesh), write it
        on a background thread (rank 0)."""
        self.wait()                 # one in flight at a time
        self._mesh = mesh = _mesh_of(tree)
        arrays = _host_tree(tree)
        _barrier(mesh)
        if not _writer(mesh):
            return

        def work():
            try:
                _write(self.directory, step, arrays, _mesh_json(mesh))
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save(self, step: int, tree: Any):
        self.wait()
        self._mesh = mesh = _mesh_of(tree)
        save_checkpoint(self.directory, step, tree)
        if _writer(mesh):
            self._gc()

    def restore_latest(self, like: Any, *, device=None, mesh=None,
                       shardings=None):
        """(step, tree) of the newest committed step, or (None, None).
        Under a mesh, rank 0's newest step (every rank restores it)."""
        step = latest_step(self.directory)
        if mesh is not None:
            import torch.distributed as dist
            box = [step]
            dist.broadcast_object_list(box, src=0)
            step = box[0]
        if step is None:
            return None, None
        return step, restore_checkpoint(self.directory, step, like,
                                        device=device, mesh=mesh,
                                        shardings=shardings)

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.directory)
            if n.startswith("step_") and os.path.exists(
                os.path.join(self.directory, n, "COMMIT")))
        for s in steps[: -self.keep_last]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"),
                          ignore_errors=True)
