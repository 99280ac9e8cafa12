"""What a configuration brings as files of its own, found by name: a model
type's operation counts (`counts/<model_type>.py`), a reference whose
layout has "zeros" and "given" weights (`reference/<reference>.py`), tiny
sizes (`tests/tiny/<config>.json`) and width pairs of its own
(`port.widths`). A second model type is made of files under a temporary
search root only; nothing of the harness is edited for it."""
from __future__ import annotations

import json
import re
import textwrap

import pytest
import torch

from perfbench.harness import common, flops, weights as wts
from perfbench.harness.common import Cell, benchmark, check_widths, \
    find_cell, port_config
from perfbench.tests import tiny

CPU = torch.device("cpu")
SERVE = [w["name"] for w in benchmark()["workloads"]
         if find_cell(w["name"]).traffic["kind"] == "serve"]

TOY_COUNTS = """
def layer_matmul_params(c):
    return 1000 * c["num_hidden_layers"]


def attention_layers(c):
    return 1


def other_prefill_flops(c, S):
    return 7.0 * S


def other_decode_flops(c, context):
    return 3.0 * context
"""

TOY_REFERENCE = """
import math

import torch


def layout(c):
    d, V, n = c["hidden_size"], c["vocab_size"], c["mamba_num_heads"]
    bf, f32 = torch.bfloat16, torch.float32
    return [("embed", (V, d), bf, "embed", d),
            ("blocks.0.mixer.A_log", (n,), f32, "given", d),
            ("blocks.0.mixer.in_proj", (d, 3 * d), bf, "in", d),
            ("blocks.0.mixer.conv_bias", (3 * d,), bf, "zeros", d),
            ("blocks.0.mixer.dt_bias", (n,), f32, "given", d),
            ("blocks.0.mixer.out_proj", (d, d), bf, "out", d),
            ("blocks.0.norm.scale", (d,), bf, "ones", d),
            ("blocks.0.moe.router", (d, 8), f32, "router", d),
            ("blocks.0.moe.bias", (8,), f32, "zeros", d),
            ("unembed", (d, V), bf, "in", d)]


def residual_branches(c):
    return 2


def initial(c, name, shape, dtype, gen, device):
    u = torch.empty(shape, dtype=torch.float32, device=device)
    if name.endswith("A_log"):
        return u.uniform_(1.0, 16.0, generator=gen).log().to(dtype)
    dt = u.uniform_(math.log(1e-3), math.log(0.1), generator=gen).exp()
    return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
"""

TOY_CONFIG = {"model_type": "toy", "reference": "toy", "hidden_size": 512,
              "num_attention_heads": 8, "num_hidden_layers": 4,
              "vocab_size": 1024, "mamba_num_heads": 16}
TOY_TINY = {"config": {"hidden_size": 16, "vocab_size": 64,
                       "mamba_num_heads": 4},
            "port": {"d_model": 16}, "limits": {"gap": 0.5}}


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """A search root holding only the toy model type's files."""
    for rel, text in (("counts/toy.py", TOY_COUNTS),
                      ("reference/toy.py", TOY_REFERENCE),
                      ("tests/tiny/toy-4L.json", json.dumps(TOY_TINY))):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text(textwrap.dedent(text))
    monkeypatch.setattr(common, "PERFBENCH", tmp_path)
    return tmp_path


def _draw(c, seed, layout=None):
    ref = common.reference(c)
    return wts.draw(ref.layout(c) if layout is None else layout,
                    ref.residual_branches(c), seed, "cpu",
                    initial=lambda *a: ref.initial(c, *a))


@pytest.mark.parametrize("S", [1, 300, 4096])
def test_a_new_model_type_is_counted_by_its_own_module(toy, S):
    c = TOY_CONFIG
    pairs = flops.visible_pairs(S, S)
    attn = flops.attention_flops(pairs, 8, 64)
    assert flops.prefill_flops(c, 2, S) == 2 * (
        S * 2.0 * 4000 + attn + 2.0 * 512 * 1024 + 7.0 * S)
    assert flops.decode_flops(c, S) == (
        2.0 * 4000 + 2.0 * 512 * 1024 + flops.attention_flops(S, 8, 64)
        + 3.0 * S)


def test_a_new_model_types_draw_repeats_and_keeps_the_other_roles(toy):
    c = TOY_CONFIG
    a, b = _draw(c, 2**33 + 7), _draw(c, 2**33 + 7)
    assert list(a) == [e[0] for e in common.reference(c).layout(c)]
    assert all(torch.equal(a[n], b[n]) for n in a)
    other = _draw(c, 2**33 + 8)
    assert not torch.equal(a["blocks.0.mixer.A_log"],
                           other["blocks.0.mixer.A_log"])
    # the roles that were there before: the same tensors as from the
    # layout without the new entries
    lay = [e for e in common.reference(c).layout(c)
           if e[3] not in ("zeros", "given")]
    plain = _draw(c, 2**33 + 7, lay)
    assert all(torch.equal(a[n], plain[n]) for n in plain)
    assert not a["blocks.0.moe.bias"].any()
    assert not a["blocks.0.mixer.conv_bias"].any()
    A = a["blocks.0.mixer.A_log"]
    assert A.dtype == torch.float32 and (A >= 0).all() \
        and (A <= torch.log(torch.tensor(16.0))).all()
    with pytest.raises(ValueError, match="given"):
        wts.draw(common.reference(c).layout(c), 2, 1, "cpu")


def test_a_new_configuration_finds_its_tiny_sizes(toy):
    cell = Cell("toy-4L.serve", {"config": "toy-4L"}, dict(TOY_CONFIG),
                {"kind": "serve", "limits": {"gap": 1.5}}, [], [])
    c, port = tiny.shrink(cell)
    assert c.config == dict(TOY_CONFIG, **TOY_TINY["config"])
    assert port == TOY_TINY["port"]
    assert c.traffic["limits"] == TOY_TINY["limits"]
    assert c.traffic["n_slots"] == tiny.TINY_SERVE["n_slots"]
    assert cell.config == TOY_CONFIG          # the cell itself is untouched


@pytest.mark.parametrize("name", SERVE)
def test_a_configuration_without_counts_fails_at_setup(name, monkeypatch):
    from perfbench.drivers import serve

    def window(*a, **k):
        raise AssertionError("the window opened")
    monkeypatch.setattr(serve.Served, "window", window)
    c, port = tiny.cell(name)
    c.config["model_type"] = "no-such-type"
    path = common.PERFBENCH / "counts" / "no-such-type.py"
    with pytest.raises(FileNotFoundError, match=re.escape(str(path))):
        serve.run(c, 2**31 + 13, 0.3, False, CPU, port)


@pytest.mark.parametrize("name", SERVE)
def test_a_listed_width_pair_that_disagrees_raises(name):
    c, port = tiny.cell(name)
    cfg = port_config(c.config, port)
    f = dict(c.config, port=dict(c.config["port"],
                                 widths={"d_ff": "ffn_width"}))
    check_widths(cfg, dict(f, ffn_width=cfg.d_ff))
    with pytest.raises(RuntimeError, match="d_ff"):
        check_widths(cfg, dict(f, ffn_width=cfg.d_ff + 1))
    with pytest.raises(KeyError, match="ffn_width"):
        check_widths(cfg, f)
