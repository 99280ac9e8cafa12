"""Cost analysis of one rank's program (port of `repro.launch.hlo_analysis`).

The reference compiles the per-device SPMD program with XLA and walks its
optimized HLO text (`analyze(text, n_devices)`, the group size of a
collective without replica groups defaulting to n_devices), multiplying
loop bodies by their trip counts. The port's program is eager: `Analyzer` is a
`TorchDispatchMode` that sits below DTensor (it declines DTensor
arguments, so DTensor turns each call into its local operations and
collectives first) and sees every operation of one rank, on real
tensors or on fake ones (`FakeTensorMode`, where nothing is allocated
and, over the fake process group, no collective moves data). Every loop
iteration runs, so no trip count is ever unknown. It returns the
reference's dict:

  * flops            - 2*M*N*K for every mm, addmm, bmm and baddbmm, in
                       place or not (and 2*M*K for mv, 2*K for dot); the
                       flash entry
                       (`repro_torch::flash_attention_fwd`, seen once per
                       call) 4*hd operations a (query, key) pair per head
                       over the (chunk_q, chunk_kv) tiles it visits,
                       whole tiles counted, and 2 dots per such tile (its
                       QK and PV products), as the reference's blocked
                       flash counts its tile loop
  * mem_bytes        - HBM-traffic proxy: OUTPUT bytes of every
                       materializing operation, x 1.5 for read-back by
                       consumers. Views, bool outputs and fills / aranges
                       / empties are skipped (the reference's _SKIP_MEM
                       and pred rules); an in-place operation counts the
                       bytes it writes: its target (a slice copy, the
                       reference's dynamic-update-slice), or for an index
                       write its values
  * collectives      - wire bytes per collective type with ring
                       multipliers: all-reduce 2(g-1)/g of the input,
                       all-gather (g-1)/g of the output, reduce-scatter
                       and all-to-all (g-1)/g of the input, others 1

All numbers are PER-RANK; a collective's group size is its process
group's. `unknown_trip_counts` is always 0. Beside the dict,
`peak_live_bytes` is the exact peak of the bytes held by the storages the
run allocated (fills and empties included): each new storage is counted
when an operation returns it and dropped when it dies (a finalizer on
its Python object, which torch keeps alive exactly as long as the
storage), so the peak is taken at every operation to the storage.

An all-to-all that DTensor runs on a CPU mesh (the fake and gloo groups)
is an all-gather plus a chunk (`shard_dim_alltoall`'s fallback); the
analyzer counts each such call once, as the all-to-all of its input that
an nccl group runs (`_dtensor::shard_dim_alltoall`, counted as such on
the card), and keeps the number of calls in `alltoall_fallbacks`.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.models.common import is_dtensor

_DTYPE_BYTES = {
    "pred": 1, "s4": 0.5, "u4": 0.5, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "s32": 4, "u32": 4, "s64": 8, "u64": 8, "f8e4m3fn": 1, "f8e5m2": 1,
    "f8e4m3b11fnuz": 1, "bf16": 2, "f16": 2, "f32": 4, "f64": 8,
    "c64": 8, "c128": 16, "token": 0, "opaque": 0,
}
_HLO_DTYPE = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.int32: "s32", torch.int64: "s64",
    torch.float8_e4m3fn: "f8e4m3fn", torch.float8_e5m2: "f8e5m2",
    torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32",
    torch.float64: "f64", torch.complex64: "c64", torch.complex128: "c128",
}
MEM_READBACK = 1.5

_WIRE_MULT = {
    "all-reduce": lambda g: 2.0 * (g - 1) / g,
    "all-gather": lambda g: (g - 1) / g,
    "reduce-scatter": lambda g: (g - 1) / g,
    "all-to-all": lambda g: (g - 1) / g,
}
# torch's functional collectives (what DTensor calls), and DTensor's
# all-to-all on an nccl mesh, by (namespace, name) -> HLO name
_COLLECTIVES = {("_c10d_functional", k): v for k, v in {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "collective-broadcast",
}.items()}
_COLLECTIVES["_dtensor", "shard_dim_alltoall"] = "all-to-all"
_NO_MEM = {
    "arange", "full", "full_like", "zeros", "zeros_like", "ones",
    "ones_like", "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "new_zeros", "new_ones", "new_full", "fill_",
    "fill", "zero_", "scalar_tensor", "lift_fresh", "lift_fresh_copy",
    "_unsafe_view", "detach", "alias", "wait_tensor",
}
_DOTS = ("mm", "bmm", "addmm", "baddbmm", "mv", "dot")
_INDEX_WRITES = {"index_put_": 2, "_index_put_impl_": 2, "index_copy_": 3,
                 "scatter_": 3, "index_add_": 3, "masked_scatter_": 2}


def type_str(t: torch.Tensor) -> str:
    """The HLO type expression of a tensor: "bf16[8,64,64]"."""
    return f"{_HLO_DTYPE.get(t.dtype, 'opaque')}[" \
        f"{','.join(str(int(d)) for d in t.shape)}]"


def nbytes(t: torch.Tensor) -> float:
    return t.numel() * _DTYPE_BYTES[_HLO_DTYPE.get(t.dtype, "opaque")]


@dataclass
class Cost:
    flops: float = 0.0
    mem_bytes: float = 0.0
    coll_wire: float = 0.0
    coll_by_type: Dict[str, float] = field(default_factory=dict)
    mem_by_shape: Dict[str, float] = field(default_factory=dict)
    coll_count: int = 0
    dot_count: int = 0


def _group_size(name: str, args) -> int:
    if name in ("all_gather_into_tensor", "reduce_scatter_tensor",
                "all_gather_into_tensor_coalesced",
                "reduce_scatter_tensor_coalesced"):
        return int(args[-2])
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(args[-1]).size()


def _flash_cost(args) -> tuple:
    """(flops, dots) of one flash entry call."""
    from repro_torch.kernels.flash_attention.kernel import visited_work
    q, k = args[0], args[1]
    q_offset, causal, window, kv_len, chunk_q, chunk_kv = args[3:9]
    B, Sq, H, hd = q.shape
    pairs, tiles = visited_work(Sq, k.shape[1], q_offset=q_offset,
                                causal=causal, window=window, kv_len=kv_len,
                                chunk_q=chunk_q, chunk_kv=chunk_kv)
    return 4.0 * B * H * hd * pairs, 2 * tiles


def _dot_flops(name, args) -> float:
    if name in ("mm", "bmm"):
        a, b = args[0], args[1]
    elif name in ("addmm", "baddbmm"):
        a, b = args[1], args[2]
    elif name == "mv":
        return 2.0 * args[0].shape[0] * args[0].shape[1]
    else:                                   # dot
        return 2.0 * args[0].shape[0]
    batch = a.shape[0] if a.dim() == 3 else 1
    return 2.0 * batch * a.shape[-2] * a.shape[-1] * b.shape[-1]


# DTensor's method that derives an operation's global output shape by
# running it on fake tensors of the global shapes (torch 2.5 and later)
SHAPE_INFERENCE = "_propagate_tensor_meta_non_cached"


def _count_alltoall_fallback(an) -> Callable:
    """Count each CPU-mesh all-to-all of DTensor (`shard_dim_alltoall`'s
    all-gather plus chunk) as the one all-to-all an nccl group runs: the
    fallback's own operations are not counted, its output is. Returns the
    function that undoes it."""
    from torch.distributed.tensor import placement_types as pt
    orig = pt.shard_dim_alltoall

    def counted(input, gather_dim, shard_dim, mesh, mesh_dim):
        if mesh.device_type != "cpu" or an._paused:
            return orig(input, gather_dim, shard_dim, mesh, mesh_dim)
        an._paused += 1
        try:
            out = orig(input, gather_dim, shard_dim, mesh, mesh_dim)
        finally:
            an._paused -= 1
        an.alltoall_fallbacks += 1
        an._collective("all-to-all", mesh.size(mesh_dim), nbytes(input))
        an._memory(torch.ops._dtensor.shard_dim_alltoall.default,
                   "shard_dim_alltoall", (input,), out)
        return out

    pt.shard_dim_alltoall = counted
    return lambda: setattr(pt, "shard_dim_alltoall", orig)


def _hide_shape_inference(an) -> Callable:
    """Pause `an` while DTensor infers output shapes (`SHAPE_INFERENCE`
    runs each operation once more at its global shapes, on fake tensors,
    and under a FakeTensorMode at every call): that is no part of the
    program. Returns the function that undoes it."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    orig = getattr(ShardingPropagator, SHAPE_INFERENCE)

    def paused(self, *args, **kwargs):
        an._paused += 1
        try:
            return orig(self, *args, **kwargs)
        finally:
            an._paused -= 1

    setattr(ShardingPropagator, SHAPE_INFERENCE, paused)
    return lambda: setattr(ShardingPropagator, SHAPE_INFERENCE, orig)


class Analyzer(TorchDispatchMode):
    """Counts one rank's operations (see the module docstring). Enter it
    inside a FakeTensorMode for a dry run; tensors made before it is
    entered (the arguments) are not counted as live."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self._live = {}
        self._live_bytes = 0
        self.peak_live_bytes = 0
        self._paused = 0
        self.alltoall_fallbacks = 0
        self._open = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat, _ = tree_flatten((args, kwargs))
        if any(is_dtensor(t) for t in flat):
            return NotImplemented
        out = func(*args, **kwargs)
        if not self._paused:
            self._account(func, args, out)
        return out

    def __enter__(self):
        unhooks = (_hide_shape_inference(self),
                   _count_alltoall_fallback(self))
        self._unhook = lambda: [u() for u in unhooks]
        self._open = True
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._open = False
            self._unhook()

    def _account(self, func, args, out):
        c = self.cost
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns == "repro_torch" and name == "flash_attention_fwd":
            f, dots = _flash_cost(args)
            c.flops += f
            c.dot_count += dots
        elif ns == "aten" and name.rstrip("_") in _DOTS:
            c.flops += _dot_flops(name.rstrip("_"), args)
            c.dot_count += 1
        if (ns, name) in _COLLECTIVES:
            kind = _COLLECTIVES[ns, name]
            ins, _ = tree_flatten(args[0])
            outs, _ = tree_flatten(out)
            base = sum(nbytes(t) for t in (outs if "gather" in kind else ins)
                       if isinstance(t, torch.Tensor))
            self._collective(kind, _group_size(name, args), base)
        self._memory(func, name, args, out)

    def _collective(self, kind, g, base):
        """One collective of `kind` over a group of g ranks, of `base`
        bytes (its input, or its output for a gather)."""
        c = self.cost
        wire = _WIRE_MULT.get(kind, lambda g: 1.0)(max(g, 1)) * base
        c.coll_wire += wire
        c.coll_by_type[kind] = c.coll_by_type.get(kind, 0.0) + wire
        c.coll_count += 1

    def _memory(self, func, name, args, out):
        schema = func._schema
        rets = schema.returns
        write = rets and rets[0].alias_info is not None \
            and rets[0].alias_info.is_write
        view = rets and rets[0].alias_info is not None and not write
        if not (view or write):
            self._track(out)
        if view or name in _NO_MEM:
            return
        if write and name in _INDEX_WRITES:
            target = args[_INDEX_WRITES[name]]
        else:
            target = out
        c = self.cost
        for t in tree_flatten(target)[0]:
            if not isinstance(t, torch.Tensor) or t.dtype == torch.bool:
                continue
            b = MEM_READBACK * nbytes(t)
            c.mem_bytes += b
            key = type_str(t)
            c.mem_by_shape[key] = c.mem_by_shape.get(key, 0.0) + b

    def _track(self, out):
        """Count the storages of `out` not counted yet, each until it
        dies, and raise the peak to the bytes now held."""
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key not in self._live:
                n = st.nbytes()
                self._live[key] = n
                self._live_bytes += n
                weakref.finalize(st, self._died, key)
        if self._live_bytes > self.peak_live_bytes:
            self.peak_live_bytes = self._live_bytes

    def _died(self, key):
        if self._open:
            self._live_bytes -= self._live.pop(key)

    def result(self) -> dict:
        c = self.cost
        top = dict(sorted(c.mem_by_shape.items(), key=lambda kv: -kv[1])[:32])
        return {
            "flops": c.flops,
            "mem_bytes": c.mem_bytes,
            "collective_wire_bytes": c.coll_wire,
            "collective_by_type": dict(c.coll_by_type),
            "mem_by_shape_top": top,
            "collective_count": c.coll_count,
            "dot_count": c.dot_count,
            "unknown_trip_counts": 0,
        }


def analyze(fn, *args, **kwargs) -> tuple:
    """(analysis dict, fn's output, peak live bytes) of one call of
    `fn(*args, **kwargs)` under an `Analyzer`."""
    with Analyzer() as an:
        out = fn(*args, **kwargs)
    return an.result(), out, an.peak_live_bytes
