"""Port parity: the MoE FFN of `repro_torch` (`models/moe.py`: routing,
capacity, dispatch and combine) and the MoE decoder block against the
JAX reference's `mesh=None` path on the same inputs.

Reduced configs at float32 (mixtral: 4 experts, top 2; arctic adds its
dense residual MLP). `_moe_local` also on one rank's share of the
experts and of d_ff with a set capacity, as the mesh paths call it. Gates, expert ids and the aux loss are compared
within 1e-6 (ids exactly), outputs within 1e-5, the limit of
tests/test_torch_models.py.
"""
import dataclasses

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):   # removed in JAX 0.9
    jax.experimental.enable_x64 = \
        lambda new_val=True: jax.enable_x64(new_val)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import transformer as ref_tfm  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe, transformer as tfm  # noqa: E402

ATOL = 1e-5
ATOL_ROUTE = 1e-6


def _configs(arch, **over):
    ref = dataclasses.replace(ref_get_config(arch).reduced(),
                              dtype="float32", **over)
    port = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                               **over)
    return ref, port


def _pair(arch, seed=0, **over):
    ref_cfg, cfg = _configs(arch, **over)
    params = RefModel(ref_cfg).init(jax.random.key(seed))
    model = interop.model_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params), device="cpu")
    return ref_cfg, cfg, params, model


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


@pytest.mark.parametrize("E,k,ties", [(4, 2, False), (8, 2, False),
                                      (8, 2, True), (6, 3, True)])
def test_route_matches_reference(E, k, ties):
    """Gates, expert ids and the aux loss. With `ties`, router columns
    are repeated, so probabilities tie exactly and the lower expert must
    rank first, as jax.lax.top_k ranks it."""
    rng = np.random.default_rng(E + k)
    x = rng.standard_normal((37, 64)).astype(np.float32)
    w = rng.standard_normal((64, E)).astype(np.float32) * 0.3
    if ties:
        w[:, 1] = w[:, 2] = w[:, 0]
        w[:, E - 1] = w[:, E - 2]
    g_ref, i_ref, a_ref = ref_moe._route(jnp.asarray(x), jnp.asarray(w), k)
    g, i, a = moe._route(torch.tensor(x), torch.tensor(w), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    _close(g, g_ref, ATOL_ROUTE)
    _close(a, a_ref, ATOL_ROUTE)


@pytest.mark.parametrize("cf,T", [(1.25, 40), (0.5, 40), (0.25, 33),
                                  (2.0, 7)])
def test_moe_local_capacity_drops_match(cf, T):
    """Capacity drops (at a capacity factor below 1 most tokens lose an
    assignment, and some lose both) equal the reference's: the outputs
    agree, and the tokens whose every assignment was dropped are exactly
    zero in both."""
    ref_cfg, cfg, params, model = _pair("mixtral-8x7b",
                                        capacity_factor=cf)
    mp = jax.tree.map(lambda a: a[0], params["blocks"])["moe"]
    rng = np.random.default_rng(T)
    x = rng.standard_normal((T, cfg.d_model)).astype(np.float32)
    y_ref, a_ref = ref_moe._moe_local(jnp.asarray(x), mp["router"],
                                      mp["w1"], mp["w3"], mp["w2"], ref_cfg,
                                      0)
    p = model.blocks[0].moe
    y, a = moe._moe_local(torch.tensor(x), p.router, p.w1, p.w3, p.w2, cfg)
    _close(y, y_ref)
    _close(a, a_ref, ATOL_ROUTE)
    zero_ref = np.all(np.asarray(y_ref) == 0, axis=-1)
    zero = (y == 0).all(dim=-1).numpy()
    np.testing.assert_array_equal(zero, zero_ref)
    if cf <= 0.25:
        assert zero.any()     # some token lost both assignments


@pytest.mark.parametrize("e_offset,E_loc,f_slice,capacity", [
    (0, 2, None, None), (2, 2, None, None), (1, 1, None, 40),
    (0, 4, (32, 96), None), (2, 2, (0, 64), 40)])
def test_moe_local_expert_slice_matches_the_reference(e_offset, E_loc,
                                                      f_slice, capacity):
    """One rank's share as the mesh paths give it: the experts
    [e_offset, e_offset + E_loc) and, with `f_slice`, a slice of d_ff
    (w1/w3's last axis, w2's middle one), with the capacity the caller
    sets (the small-T path's C = T) or the default. The reference's
    `_moe_local` (no mesh) on the same slices and arguments: outputs
    within 1e-5, the aux loss (from the full router view) within 1e-6.
    Routed assignments outside the slice add nothing, so the slices'
    outputs sum to the whole FFN's."""
    ref_cfg, cfg, params, model = _pair("mixtral-8x7b", capacity_factor=0.5)
    mp = jax.tree.map(lambda a: a[0], params["blocks"])["moe"]
    rng = np.random.default_rng(e_offset + E_loc)
    T = 40
    x = rng.standard_normal((T, cfg.d_model)).astype(np.float32)
    a, b = f_slice or (0, cfg.d_ff)
    es = slice(e_offset, e_offset + E_loc)
    w1, w3 = (np.asarray(mp[n])[es, :, a:b] for n in ("w1", "w3"))
    w2 = np.asarray(mp["w2"])[es, a:b]
    y_ref, a_ref = ref_moe._moe_local(
        jnp.asarray(x), mp["router"], jnp.asarray(w1), jnp.asarray(w3),
        jnp.asarray(w2), ref_cfg, e_offset, capacity=capacity)
    y, aux = moe._moe_local(torch.tensor(x), model.blocks[0].moe.router,
                            torch.tensor(w1), torch.tensor(w3),
                            torch.tensor(w2), cfg, e_offset, capacity)
    _close(y, y_ref)
    _close(aux, a_ref, ATOL_ROUTE)
    p = model.blocks[0].moe
    whole, _ = moe._moe_local(torch.tensor(x), p.router, p.w1, p.w3, p.w2,
                              cfg, capacity=capacity)
    parts = sum(moe._moe_local(torch.tensor(x), p.router, p.w1[e:e + 2],
                               p.w3[e:e + 2], p.w2[e:e + 2], cfg, e,
                               capacity)[0] for e in (0, 2))
    _close(parts, whole.numpy())


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "arctic-480b"])
def test_moe_block_prefill_and_decode(arch):
    """The MoE block's prefill (output, K, V, aux) and a decode step
    against a cache; arctic adds its dense residual MLP."""
    ref_cfg, cfg, params, model = _pair(arch)
    bp = jax.tree.map(lambda a: a[0], params["blocks"])
    rng = np.random.default_rng(5)
    B, S, W = 2, 12, 16
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))
    y_ref, (k_ref, v_ref), aux_ref = ref_tfm.moe_block_prefill(
        bp, jnp.asarray(x), jnp.asarray(pos), ref_cfg)
    y, (k, v), aux = tfm.moe_block_prefill(model.blocks[0], torch.tensor(x),
                                           torch.tensor(pos), cfg)
    for g, w in ((y, y_ref), (k, k_ref), (v, v_ref)):
        _close(g, w)
    _close(aux, aux_ref, ATOL_ROUTE)

    ring = cfg.sliding_window > 0
    Wc = cfg.sliding_window or W
    ck = np.zeros((B, Wc) + tuple(k.shape[2:]), np.float32)
    cv = np.zeros_like(ck)
    ck[:, :S], cv[:, :S] = np.asarray(k_ref), np.asarray(v_ref)
    x1 = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    p1 = np.full((B,), S, np.int32)
    want = ref_tfm.moe_block_decode(bp, jnp.asarray(x1), jnp.asarray(ck),
                                    jnp.asarray(cv), jnp.asarray(p1),
                                    ref_cfg, ring=ring)
    got = tfm.moe_block_decode(model.blocks[0], torch.tensor(x1),
                               torch.tensor(ck), torch.tensor(cv),
                               torch.tensor(p1), cfg, ring=ring)
    for g, w in zip(got, want):
        _close(g, w)


def test_moe_apply_in_bf16_keeps_the_router_in_float32():
    """In bf16 the router weight stays float32 (routing runs in float32)
    while dispatch, the expert products and the combine run in bf16; the
    output agrees with the reference within the bf16 limit."""
    ref_cfg, cfg = _configs("mixtral-8x7b")
    ref_cfg = dataclasses.replace(ref_cfg, dtype="bfloat16")
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    params = RefModel(ref_cfg).init(jax.random.key(3))
    model = interop.model_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params), device="cpu")
    mp = jax.tree.map(lambda a: a[0], params["blocks"])["moe"]
    p = model.blocks[0].moe
    assert p.router.dtype == torch.float32 and p.w1.dtype == torch.bfloat16
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    y_ref, _ = ref_moe.apply(mp, jnp.asarray(x, jnp.bfloat16), ref_cfg)
    y, _ = moe.apply(p, torch.tensor(x).bfloat16(), cfg)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(y_ref, np.float32), rtol=0,
                               atol=3e-2)
