"""The benchmark's plain references against the program on the CPU, at
tiny widths in float32: the same weights (drawn by the harness) through
the program's `Model` and through each configuration's reference give the
same logits. The reference files themselves import nothing of the
program; this test imports both."""
from __future__ import annotations

import dataclasses
import hashlib

import pytest
import torch

from perfbench.harness import weights as wts
from perfbench.harness.common import benchmark, port_config, reference
from perfbench.reference import mixtral
from perfbench.tests import tiny

CONFIGS = [c["name"] for c in benchmark()["configs"]]
# the configuration whose reference is `reference/mixtral.py`
MIXTRAL = "mixtral-8x7b-8L"


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _draw(ref, c, seed, layout=None):
    return wts.draw(ref.layout(c) if layout is None else layout,
                    ref.residual_branches(c), seed, "cpu",
                    initial=lambda *a: ref.initial(c, *a))


def _float32(name):
    c, port = tiny.config(name)
    c["torch_dtype"] = "float32"
    cfg = port_config(c, dict(port, dtype="float32"))
    ref = reference(c)
    lay = [(n, s, torch.float32, r, f) for n, s, _, r, f in ref.layout(c)]
    w = _draw(ref, c, 5, lay)
    from repro_torch.models.model import Model
    model = wts.load_into(Model(cfg, device="meta"), w)
    return c, ref, w, model


@pytest.mark.parametrize("S", [7, 32, 45])
def test_mixtral_reference_equals_the_program(S):
    """Every configuration's reference, mixtral's among them."""
    for name in CONFIGS:
        c, ref, w, model = _float32(name)
        toks = torch.randint(0, c["vocab_size"], (1, S),
                             generator=torch.Generator().manual_seed(S))
        got = model.prefill({"tokens": toks.to(torch.int32)}, W=64)[0][0]
        want = ref.logits(c, w, toks[0], torch.tensor([S - 1]))[0]
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_layouts_are_the_programs_parameters():
    from repro_torch.models.model import Model
    for name in CONFIGS:
        c, port = tiny.config(name)
        model = Model(port_config(c, port), device="meta")
        assert {n: (tuple(p.shape), p.dtype)
                for n, p in model.named_parameters()} == {
            n: (s, d) for n, s, d, _, _ in reference(c).layout(c)}


def test_weights_repeat_for_a_seed_and_keep_the_stream_near_unit():
    c, port = tiny.config(MIXTRAL)
    cf = dict(c, num_hidden_layers=8)
    lay = mixtral.layout(cf)
    a = wts.draw(lay, mixtral.residual_branches(cf), 2**32 + 1, "cpu")
    b = wts.draw(lay, mixtral.residual_branches(cf), 2**32 + 1, "cpu")
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert dataclasses.is_dataclass(port_config(c, port))
    toks = torch.randint(0, cf["vocab_size"], (32,))
    h = a["embed"][toks].float()
    pos = torch.arange(32)
    for l in range(cf["num_hidden_layers"]):
        h = mixtral.moe_block(cf, a, l, mixtral.attention_block(
            cf, a, l, h, pos))
    assert 0.5 < float(h.pow(2).mean().sqrt()) < 2.0


def digest(weights, layout) -> str:
    """sha256 over every tensor's name and bytes, in layout order."""
    h = hashlib.sha256()
    for name, *_ in layout:
        h.update(name.encode())
        h.update(weights[name].contiguous().flatten().view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def test_the_tiny_mixtral_draw_is_bit_for_bit_the_first_harness_draw():
    """The digest of the tiny mixtral layout's weights at seed 2**31 + 5,
    as the harness drew them before the roles "zeros" and "given" came."""
    c, _ = tiny.config(MIXTRAL)
    lay = mixtral.layout(c)
    w = wts.draw(lay, mixtral.residual_branches(c), 2**31 + 5, "cpu")
    assert digest(w, lay) == ("79969fb47bd077326a7cdeae1d2a8f31"
                              "cd04a3460421c9e8bae4d8d0a29098af")


def test_the_bf16_witness_routes_on_the_bf16_rounded_state():
    """The witness's router sees the normed state rounded to bf16, as the
    program's does; the float32 reference's sees it unrounded."""
    c, _ = tiny.config(MIXTRAL)
    lay = mixtral.layout(c)
    w = wts.draw(lay, mixtral.residual_branches(c), 2**31 + 3, "cpu")
    seen = []
    real = torch.softmax

    def spy(x, dim=None):
        seen.append(x)
        return real(x, dim=dim)
    h = torch.randn(16, c["hidden_size"],
                    generator=torch.Generator().manual_seed(4))
    g = lambda n: w["blocks.0." + n].float()  # noqa: E731
    x = mixtral.rms_norm(h, g("n2.scale"), c["rms_norm_eps"])
    try:
        torch.softmax = spy
        mixtral.moe_block(c, w, 0, h, "bf16")
        mixtral.moe_block(c, w, 0, h)
    finally:
        torch.softmax = real
    torch.testing.assert_close(
        seen[0], x.to(torch.bfloat16).float() @ g("moe.router"),
        rtol=0, atol=0)
    torch.testing.assert_close(seen[1], x @ g("moe.router"), rtol=0, atol=0)
