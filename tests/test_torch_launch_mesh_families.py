"""The mesh steps of the moe, hybrid, ssm, audio and vlm families on real
ranks: two CPU processes (`torch.multiprocessing.spawn`) on a gloo
process group run each family's prefill, decode and train bundles
(`launch.steps.build`) on DeviceMeshes (1, 2) and (2, 1) and hold them,
on every rank, to the same model without a mesh, as
tests/test_torch_launch_mesh.py does for the dense family.

Reduced configs in float32 at 2 layers (one of each kind: zamba2's
Mamba2 layer and shared block, xlstm's mLSTM and sLSTM, whisper's
encoder and decoder layers), B = 8, one thread a rank: mixtral-8x7b (4
experts, a sliding window of 32, so its decode writes a ring) and
arctic-480b (its dense residual MLP beside the experts), zamba2-2.7b
(`ssm.CHUNK = 8`, so the prompt runs as several chunks), xlstm-1.3b
(`xlstm.CHUNK = 16`), whisper-large-v3 (8 frames) and internvl2-1b (4
patches before the prompt). Prefill logits, its cache and pos; the logits and the whole
cache after a decode step from that cache; one train step from step 1
(lr > 0): loss, gradient norm and the moments within 1e-5 of the
largest, the master within 1e-4 of each leaf's largest and moved past
twice that (tests/test_torch_launch_mesh.py gives the reason for the
master's limit). Every mesh step makes collectives.

The MoE FFN is held to the unsharded port applied as the mesh applies
it (`_AS`), never to inputs chosen so that nothing is dropped:
  * small-T (the default `moe.SMALL_T` of 4,096 tokens: every step here
    on (1, 2)): tokens replicated, capacity C = T, dropless, so the
    unsharded `_moe_local` runs with capacity=T;
  * expert-parallel (`SMALL_T = 0`, 4 experts over 'model' = 2; and on
    (2, 1), where 'model' = 1 holds every expert and the tokens split
    over 'data', also at B = 1, whose 64 tokens split though its batch
    does not): each data shard takes its capacity from its own tokens,
    so the unsharded `_moe_local` runs on each shard's tokens and the
    outputs are joined (the aux loss is their mean);
  * tensor-parallel on d_ff (`SMALL_T = 0`, `n_experts = 3`, which does
    not divide 'model' = 2), held to the plain `_moe_local`.
A spy on `moe._apply_small_t` / `moe._apply_parallel` records which path
each step took, and the test asserts it, as test_attention_paths does
for the flash. The unsharded capacity is also checked to drop tokens at
these shapes (the default run differs from the dropless one), so the
small-T semantics are seen.

The ranks run in at most `LIMIT` seconds; past it the test kills them
and fails instead of hanging. Each rank closes its process group.
"""
import dataclasses
import json
import math
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

# a guard against a hung rank: ~40 s alone, several times that on a host
# shared with other test workers
LIMIT = 300.0
TOL = 1e-5
PARAM_TOL = 1e-4    # the updated master, of each leaf's largest
# a leaf whose largest value after the step is under this many lr
# started at zero (a bias): it holds nothing but steps
ZERO_START = 10
B = 8
# mixtral's expert-parallel path with B = 1 on (2, 1): the batch does not
# split over 'data' but its B*S tokens do (the reference's rule), and a
# decode step's one token does not (replicated)
BATCH = {"mixtral EP token split (2, 1)": 1}
# prompt lengths: past mixtral's window of 32 (a ring that wraps), and
# 4 chunks of zamba2's Mamba2 and 2 of xlstm's mLSTM
SEQ = {"zamba2-2.7b": 32, "xlstm-1.3b": 32}
S_DEFAULT = 64
# (label, arch, config overrides, mesh, moe.SMALL_T or None, MoE path)
CASES = (
    ("mixtral small-T (1, 2)", "mixtral-8x7b", {}, (1, 2), None, "small_t"),
    ("mixtral EP split (2, 1)", "mixtral-8x7b", {}, (2, 1), 0, "ep"),
    ("mixtral EP token split (2, 1)", "mixtral-8x7b", {}, (2, 1), 0, "ep"),
    ("mixtral EP (1, 2)", "mixtral-8x7b", {}, (1, 2), 0, "ep"),
    ("mixtral TP (1, 2)", "mixtral-8x7b", {"n_experts": 3}, (1, 2), 0,
     "tp"),
    ("arctic small-T (1, 2)", "arctic-480b", {}, (1, 2), None, "small_t"),
    ("arctic EP split (2, 1)", "arctic-480b", {}, (2, 1), 0, "ep"),
) + tuple((f"{arch} {m}", arch, {}, m, None, None)
          for arch in ("zamba2-2.7b", "xlstm-1.3b", "whisper-large-v3",
                       "internvl2-1b")
          for m in ((1, 2), (2, 1)))
LABELS = tuple(c[0] for c in CASES)
# the cases run by two pairs of ranks at once, each on its own group
GROUPS = (tuple(c for c in CASES if c[1] not in SEQ),
          tuple(c for c in CASES if c[1] in SEQ))


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _rel(got, want) -> float:
    got = _full(got)
    want = want.float()
    return float((got.float() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


class _AS:
    """The unsharded port's `_moe_local` applied as the mesh path applies
    it: "small_t" with capacity=T, "split" on each of n data shards'
    tokens (outputs joined, aux averaged), else as it is."""

    def __init__(self, how, n=1):
        self.how, self.n = how, n

    def __enter__(self):
        from repro_torch.models import moe
        self.orig = orig = moe._moe_local

        def local(x, *a, **kw):
            if self.how == "small_t":
                return orig(x, *a, **kw, capacity=x.shape[0])
            if self.how == "split" and self.n > 1:
                parts = [orig(c, *a, **kw) for c in x.chunk(self.n)]
                return (torch.cat([p[0] for p in parts]),
                        sum(p[1] for p in parts) / self.n)
            return orig(x, *a, **kw)
        moe._moe_local = local
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._moe_local = self.orig


def _inputs(cfg, rng, n_tok, B=B):
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (B, n_tok)), dtype=torch.int32)}
    if cfg.family == "audio":
        batch["frames"] = torch.as_tensor(rng.standard_normal(
            (B, cfg.enc_frames, cfg.d_model)), dtype=torch.float32)
    if cfg.family == "vlm":
        batch["patches"] = torch.as_tensor(rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)), dtype=torch.float32)
    return batch


def _cache_errs(got, want) -> dict:
    return {k: _rel(got[k], want[k]) for k in want}


def _serve_checks(cfg, mesh, ref_as, out, tag, S, B):
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.launch.hlo_analysis import Analyzer
    from repro_torch.models.model import Model
    rng = np.random.default_rng(0)
    n_tok = S - cfg.n_patches if cfg.family == "vlm" else S
    batch = _inputs(cfg, rng, n_tok, B)
    ref = Model(cfg, device="cpu", seed=0)
    with ref_as:
        lg0, cache0, pos0 = ref.prefill(batch, S)
    b = steps.build(cfg, mesh, ShapeConfig("p", S, B, "prefill"))
    with Analyzer() as an:
        lg, cache, pos = b.fn(*b.shard(batch))
    out[f"{tag} prefill"] = {
        "logits": _rel(lg, lg0), "pos": _rel(pos, pos0),
        **_cache_errs(cache, cache0),
        "collectives": an.result()["collective_count"]}
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, 1)),
                          dtype=torch.int32)
    p = torch.as_tensor(rng.integers(S // 2, S, (B,)), dtype=torch.int32)
    want_cache = {k: v.clone() for k, v in cache0.items()}
    with ref_as:
        lgd0, want_cache = ref.decode_step(want_cache, tok, p)
    d = steps.build(cfg, mesh, ShapeConfig("d", S, B, "decode"))
    args = d.shard({k: v.clone() for k, v in cache0.items()}, tok, p)
    with Analyzer() as an:
        lgd, got_cache = d.fn(*args)
    out[f"{tag} decode"] = {
        "logits": _rel(lgd, lgd0), **_cache_errs(got_cache, want_cache),
        "collectives": an.result()["collective_count"]}


def _train_check(cfg, mesh, ref_as, out, tag, S, B):
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.launch.hlo_analysis import Analyzer
    from repro_torch.models.model import Model
    from repro_torch.optim.optimizers import tree_leaves
    rng = np.random.default_rng(1)
    n_tok = S - cfg.n_patches if cfg.family == "vlm" else S
    batch = _inputs(cfg, rng, n_tok, B)
    batch["labels"] = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (B, n_tok)), dtype=torch.int32)
    model = Model(cfg, device="cpu", seed=0)
    plain = steps.build_train(cfg, total_steps=50)
    with ref_as:
        # step 0 has lr 0: it fills the moments; the checked step is 1
        state, _ = plain.step(plain.init_state(model), batch)
        new0, met0 = plain.step(state, batch)
    b = steps.build(cfg, mesh, ShapeConfig("t", S, B, "train"),
                    total_steps=50)
    with Analyzer() as an:
        new, met = b.fn(*b.shard(state, batch))

    def worst(key, floor=0.0):
        return max(_rel(g, w) for g, w in zip(tree_leaves(new[key]),
                                              tree_leaves(new0[key]))
                   if float(w.abs().max()) >= floor)

    def step_norm(tree):
        return math.sqrt(sum(float(((_full(g) - s0) ** 2).sum())
                             for g, s0 in zip(tree_leaves(tree),
                                              tree_leaves(state["params"]))))
    out[f"{tag} train"] = {
        "loss": _rel(met["loss"], met0["loss"]),
        "aux": _rel(met["aux"], met0["aux"]) if float(met0["aux"]) else 0.0,
        "grad_norm": _rel(met["grad_norm"], met0["grad_norm"]),
        "moments": worst("opt"),
        "params": worst("params", ZERO_START * float(met0["lr"])),
        "step": abs(step_norm(new["params"])
                    / step_norm(new0["params"]) - 1),
        "collectives": an.result()["collective_count"]}
    out[f"{tag} train moved"] = {
        "lr": float(met0["lr"]),
        "params": max(_rel(w, s) for w, s in zip(
            tree_leaves(new0["params"]), tree_leaves(state["params"])))}


def _drops(cfg, S=S_DEFAULT) -> float:
    """How far the unsharded MoE FFN with its default capacity is from
    the dropless one at a prefill's token count (0: nothing dropped)."""
    from repro_torch.models.model import Model
    batch = _inputs(cfg, np.random.default_rng(0), S)
    ref = Model(cfg, device="cpu", seed=0)
    lg, _, _ = ref.prefill(batch, S)
    with _AS("small_t"):
        lg_t, _, _ = ref.prefill(batch, S)
    return _rel(lg, lg_t)


def _worker(rank, path, group):
    out = {}
    try:
        torch.set_num_threads(1)
        from repro_torch.configs import get_config
        from repro_torch.launch import mesh as M
        from repro_torch.models import moe, ssm, xlstm
        ssm.CHUNK, xlstm.CHUNK = 8, 16
        paths = []
        spied = {n: getattr(moe, n) for n in ("_apply_small_t",
                                              "_apply_parallel")}

        def spy(name):
            def f(*a, **kw):
                paths.append("small_t" if name == "_apply_small_t"
                             else "ep" if a[-1] else "tp")
                return spied[name](*a, **kw)
            return f
        for n in spied:
            setattr(moe, n, spy(n))
        # a file store in the test's own directory: no port to race for
        # with another test's group
        M.open_group(2, backend="gloo", rank=rank,
                     init_method=f"file://{path}/store")
        try:
            for label, arch, over, sizes, small_t, _ in GROUPS[group]:
                S = SEQ.get(arch, S_DEFAULT)
                cfg = dataclasses.replace(get_config(arch).reduced(),
                                          dtype="float32", n_layers=2,
                                          **over)
                mesh = M.make_test_mesh(*sizes)
                moe.SMALL_T = 4096 if small_t is None else small_t
                how = ("small_t" if moe.SMALL_T else "split") \
                    if cfg.family == "moe" else None
                ref_as = _AS(how, sizes[0])
                del paths[:]
                t0 = time.perf_counter()
                b = BATCH.get(label, B)
                _serve_checks(cfg, mesh, ref_as, out, label, S, b)
                _train_check(cfg, mesh, ref_as, out, label, S, b)
                out[f"{label} paths"] = sorted(set(paths))
                out[f"{label} wall"] = time.perf_counter() - t0
            moe.SMALL_T = 4096
            for arch in ("mixtral-8x7b", "arctic-480b") if group == 0 \
                    else ():
                cfg = dataclasses.replace(get_config(arch).reduced(),
                                          dtype="float32")
                out[f"{arch} drops"] = _drops(cfg)
        finally:
            M.close_group()
            out["closed"] = not torch.distributed.is_initialized()
    except Exception as e:                # reported to the parent test
        import traceback
        out["error"] = f"{e!r}\n{traceback.format_exc()}"
    with open(f"{path}/rank{rank}.json", "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    paths = [tmp_path_factory.mktemp(f"mesh_families{g}")
             for g in range(len(GROUPS))]
    ctxs = [mp.spawn(_worker, args=(str(path), g), nprocs=2, join=False)
            for g, path in enumerate(paths)]
    deadline = time.monotonic() + LIMIT
    for ctx in ctxs:
        while not ctx.join(timeout=2.0):
            if time.monotonic() > deadline:
                for c in ctxs:
                    for p in c.processes:
                        p.kill()
                pytest.fail(f"the ranks did not finish in {LIMIT} s")
    out = [{}, {}]
    for path in paths:
        for r in range(2):
            o = json.load(open(path / f"rank{r}.json"))
            assert "error" not in o, f"{path} rank {r}: {o['error']}"
            out[r].update(o)
    return out


@pytest.mark.parametrize("rank", [0, 1])
def test_ranks_close_their_group(results, rank):
    assert results[rank]["closed"]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("label", LABELS)
def test_mesh_serve_step_equals_the_unsharded_model(results, label, kind):
    for r in range(2):
        got = dict(results[r][f"{label} {kind}"])
        assert got.pop("collectives") > 0, (r, got)
        assert max(got.values()) <= TOL, (r, got)


@pytest.mark.parametrize("case", CASES, ids=LABELS)
def test_mesh_train_step_equals_the_unsharded_step(results, case):
    """Loss, aux, gradient norm and every moment within TOL, and the
    norm of the master's step over the whole tree within TOL (as phase
    11e of chip_smoke.py holds the bf16 step). AdamW configs also hold
    the master elementwise within PARAM_TOL of each leaf's largest, but
    for the leaves that started at zero (under ZERO_START lr after the
    step: biases such as conv_b and bk, made of normalized steps alone,
    where "of its largest" divides rounding by lr; bk's gradient is zero
    in exact arithmetic, a key bias adds the same q.b to every score of
    a query, so its step is AdamW's normalization of rounding noise:
    4.8e-3 of its largest, measured on internvl2). Adafactor (arctic)
    divides each gradient by its own root mean square (eps 1e-30), so an
    element whose gradient is at rounding level moves by +-lr either way
    (1.9e-3 of wq's largest at one element, measured): it is held by the
    step norm alone."""
    from repro_torch.configs import get_config
    label = case[0]
    adafactor = get_config(case[1]).optimizer == "adafactor"
    for r in range(2):
        got = dict(results[r][f"{label} train"])
        assert got.pop("collectives") > 0, (r, got)
        params = got.pop("params")
        assert max(got.values()) <= TOL, (r, got)
        assert adafactor or params <= PARAM_TOL, (r, params)
        moved = results[r][f"{label} train moved"]
        assert moved["lr"] > 0 and moved["params"] > 2 * PARAM_TOL, (r,
                                                                      moved)


@pytest.mark.parametrize("case", [c for c in CASES if c[5]],
                         ids=[c[0] for c in CASES if c[5]])
def test_moe_takes_the_intended_path(results, case):
    for r in range(2):
        assert results[r][f"{case[0]} paths"] == [case[5]]


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "arctic-480b"])
def test_unsharded_capacity_drops_tokens(results, arch):
    """The default capacity drops assignments at these shapes, so the
    small-T path's dropless semantics are really exercised."""
    assert results[0][f"{arch} drops"] > 10 * TOL
