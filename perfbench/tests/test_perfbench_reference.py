"""The benchmark's plain references against the program on the CPU, at
tiny widths in float32: the same weights (drawn by the harness) through
the program's `Model` and through the reference give the same logits. The reference files themselves import nothing of the
program; this test imports both."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from perfbench.harness import weights as wts
from perfbench.harness.common import port_config
from perfbench.reference import mixtral
from perfbench.tests import tiny


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _float32(name):
    c, port = tiny.cell(name)
    c.config["torch_dtype"] = "float32"
    cfg = port_config(c.config, dict(port, dtype="float32"))
    lay = [(n, s, torch.float32, r, f) for n, s, _, r, f
           in mixtral.layout(c.config)]
    w = wts.draw(lay, mixtral.residual_branches(c.config), 5, "cpu")
    from repro_torch.models.model import Model
    model = wts.load_into(Model(cfg, device="meta"), w)
    return c.config, cfg, w, model


@pytest.mark.parametrize("S", [7, 32, 45])
def test_mixtral_reference_equals_the_program(S):
    c, cfg, w, model = _float32("mixtral-8L.long-prompt")
    toks = torch.randint(0, c["vocab_size"], (1, S),
                         generator=torch.Generator().manual_seed(S))
    got = model.prefill({"tokens": toks.to(torch.int32)}, W=64)[0][0]
    want = mixtral.logits(c, w, toks[0], torch.tensor([S - 1]))[0]
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_layouts_are_the_programs_parameters():
    from repro_torch.models.model import Model
    c, port = tiny.cell("mixtral-8L.long-prompt")
    model = Model(port_config(c.config, port), device="meta")
    assert {n: (tuple(p.shape), p.dtype)
            for n, p in model.named_parameters()} == {
        n: (s, d) for n, s, d, _, _ in mixtral.layout(c.config)}


def test_weights_repeat_for_a_seed_and_keep_the_stream_near_unit():
    c, port = tiny.cell("mixtral-8L.long-prompt")
    cf = dict(c.config, num_hidden_layers=8)
    lay = mixtral.layout(cf)
    a = wts.draw(lay, mixtral.residual_branches(cf), 2**32 + 1, "cpu")
    b = wts.draw(lay, mixtral.residual_branches(cf), 2**32 + 1, "cpu")
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert dataclasses.is_dataclass(port_config(c.config, port))
    toks = torch.randint(0, cf["vocab_size"], (32,))
    h = a["embed"][toks].float()
    pos = torch.arange(32)
    for l in range(cf["num_hidden_layers"]):
        h = mixtral.moe_block(cf, a, l, mixtral.attention_block(
            cf, a, l, h, pos))
    assert 0.5 < float(h.pow(2).mean().sqrt()) < 2.0


def test_the_bf16_witness_routes_on_the_bf16_rounded_state():
    """The witness's router sees the normed state rounded to bf16, as the
    program's does; the float32 reference's sees it unrounded."""
    c, _ = tiny.cell("mixtral-8L.long-prompt")
    lay = mixtral.layout(c.config)
    w = wts.draw(lay, mixtral.residual_branches(c.config), 2**31 + 3, "cpu")
    seen = []
    real = torch.softmax

    def spy(x, dim=None):
        seen.append(x)
        return real(x, dim=dim)
    h = torch.randn(16, c.config["hidden_size"],
                    generator=torch.Generator().manual_seed(4))
    g = lambda n: w["blocks.0." + n].float()  # noqa: E731
    x = mixtral.rms_norm(h, g("n2.scale"), c.config["rms_norm_eps"])
    try:
        torch.softmax = spy
        mixtral.moe_block(c.config, w, 0, h, "bf16")
        mixtral.moe_block(c.config, w, 0, h)
    finally:
        torch.softmax = real
    torch.testing.assert_close(
        seen[0], x.to(torch.bfloat16).float() @ g("moe.router"),
        rtol=0, atol=0)
    torch.testing.assert_close(seen[1], x @ g("moe.router"), rtol=0, atol=0)
