"""Port parity of the serving slice as a whole: the `ServeEngine` of
`repro_torch` against the JAX reference's on the same weights (carried
over by `interop.model_params_from_numpy`), in both modes, with more
requests than slots; and the two samplers.

Reduced configs at float32. Greedy token streams must be equal token for
token: the logits agree to ~1e-6 (tests/test_torch_models.py) and argmax
takes the first maximum in both packages. `sample_host` is the
reference's numpy code, so one np rng state gives the same token.
`sample_tokens` draws from another random stream than the reference's
(`torch.Generator` against `jax.random`), so it is held to the top-k
support and to the greedy rows.
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
from repro.models.model import Model as RefModel  # noqa: E402
from repro.serving import ServeEngine as RefEngine  # noqa: E402
from repro.serving.engine import Request as RefRequest  # noqa: E402
from repro.serving.sampling import sample_host as ref_sample_host  # noqa: E402,E501
from repro.serving.sampling import sample_tokens as ref_sample_tokens  # noqa: E402,E501
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.runtime import TelemetryCollector  # noqa: E402
from repro_torch.serving import (Request, ServeEngine, sample_host,  # noqa: E402,E501
                                 sample_tokens)

ARCHS = ["llama3.2-1b", "qwen2-0.5b"]
PROMPT_LENS = (6, 6, 9, 6, 9)      # two admission groups, 5 requests
N_SLOTS, MAX_NEW, CHUNK = 2, 6, 4


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    ref_cfg = dataclasses.replace(ref_get_config(arch).reduced(),
                                  dtype="float32")
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    params = RefModel(ref_cfg).init(jax.random.key(0))
    model = interop.model_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params), device="cpu")
    return ref_cfg, params, cfg, model


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in PROMPT_LENS]


def _serve(engine, request_cls, prompts, **req):
    for i, p in enumerate(prompts):
        engine.submit(request_cls(rid=i, prompt=p, max_new_tokens=MAX_NEW,
                                  **req))
    done, _ = engine.run()
    return {r.rid: list(r.out_tokens) for r in done}


@pytest.mark.parametrize("mode", ["device", "host"])
def test_greedy_streams_match_reference(pair, mode):
    ref_cfg, params, cfg, model = pair
    prompts = _prompts(cfg.vocab_size)
    kw = dict(n_slots=N_SLOTS, window=32, mode=mode, decode_chunk=CHUNK)
    want = _serve(RefEngine(ref_cfg, params, **kw), RefRequest, prompts)
    eng = ServeEngine(cfg, model, **kw)
    got = _serve(eng, Request, prompts)
    assert got == want
    assert all(len(t) == MAX_NEW for t in got.values())
    assert len(got) == len(prompts) > N_SLOTS
    assert eng.admit_syncs >= 2     # at least one admission per group


def test_device_and_host_modes_agree_and_telemetry_adds_no_sync(pair):
    _, _, cfg, model = pair
    prompts = _prompts(cfg.vocab_size)
    kw = dict(n_slots=N_SLOTS, window=32, decode_chunk=CHUNK)
    host = _serve(ServeEngine(cfg, model, mode="host", **kw), Request,
                  prompts)
    plain = ServeEngine(cfg, model, **kw)
    dev = _serve(plain, Request, prompts)
    tel = TelemetryCollector()
    watched = ServeEngine(cfg, model, telemetry=tel, **kw)
    assert _serve(watched, Request, prompts) == dev == host
    assert watched.host_syncs == plain.host_syncs
    win = tel.snapshot()
    assert win.n_admitted == win.n_retired == len(prompts)
    assert win.prefill_tokens == sum(PROMPT_LENS)
    assert win.decode_tokens == len(prompts) * (MAX_NEW - 1)
    assert sorted(s.rid for s in watched.request_log) == list(range(5))


def test_budgets_and_eos_stop_inside_a_chunk(pair):
    _, _, cfg, model = pair
    prompt = _prompts(cfg.vocab_size)[0]
    eng = ServeEngine(cfg, model, n_slots=2, window=32, decode_chunk=CHUNK)
    eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=7))
    base = eng.run()[0][0].out_tokens
    eos = base[2]                   # stops at its first occurrence
    stop = base.index(eos) + 1
    eng = ServeEngine(cfg, model, n_slots=2, window=32, decode_chunk=CHUNK)
    eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=7, eos_id=eos))
    eng.submit(Request(rid=1, prompt=prompt, max_new_tokens=1))
    eng.submit(Request(rid=2, prompt=prompt, max_new_tokens=5))
    done = {r.rid: r.out_tokens for r in eng.run()[0]}
    assert done[0] == base[:stop]
    assert done[1] == base[:1]      # finished at prefill
    assert done[2] == base[:5]      # frozen mid-chunk at its budget


class _CountingClock:
    """A deterministic engine clock: each call returns the next second."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def test_injected_clock_stamps_request_stats_like_the_reference(pair):
    ref_cfg, params, cfg, model = pair
    prompts = _prompts(cfg.vocab_size)
    kw = dict(n_slots=N_SLOTS, window=32, decode_chunk=CHUNK)
    ref = RefEngine(ref_cfg, params, clock=_CountingClock(), **kw)
    _serve(ref, RefRequest, prompts)
    eng = ServeEngine(cfg, model, clock=_CountingClock(), **kw)
    _serve(eng, Request, prompts)
    fields = ("rid", "prompt_len", "emitted", "t_submit_s", "t_admit_s",
              "t_first_s", "t_retire_s")
    stamps = lambda log: [tuple(getattr(s, f) for f in fields) for s in log]
    assert stamps(eng.request_log) == stamps(ref.request_log)
    assert len(eng.request_log) == len(prompts)
    # the injected clock wins over a collector's
    tel = TelemetryCollector()
    clock = _CountingClock()
    assert ServeEngine(cfg, model, telemetry=tel, clock=clock,
                       **kw).clock is clock


@pytest.mark.parametrize("top_k_max", [64, 128])
def test_top_k_max_sets_the_device_sampler_width(pair, top_k_max):
    """A device-mode request with top_k = 100 draws from its top 100 under
    top_k_max = 128, beyond the top 64, with no clipping warning; under
    the default 64 it warns and stays inside the top 64."""
    import warnings
    _, _, cfg, model = pair
    prompt = _prompts(cfg.vocab_size)[0]
    logits, _, _ = model.prefill(
        {"tokens": torch.tensor(prompt[None].astype(np.int32))}, W=32)
    rank = np.argsort(np.argsort(-logits[0].float().numpy()))
    eng = ServeEngine(cfg, model, n_slots=4, window=32, decode_chunk=CHUNK,
                      top_k_max=top_k_max, seed=1)
    assert eng.top_k_max == top_k_max
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for rid in range(48):
            eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=1,
                               temperature=50.0, top_k=100))
    assert len(caught) == (48 if top_k_max < 100 else 0)
    done, _ = eng.run()
    ranks = np.array([rank[r.out_tokens[0]] for r in done])
    assert len(ranks) == 48
    assert ranks.max() < min(100, top_k_max)
    if top_k_max > 64:
        assert (ranks >= 64).sum() >= 5


def test_sample_host_equals_reference():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((12, 40)).astype(np.float32) * 3
    for temp, top_k in ((0.0, 40), (0.7, 40), (1.3, 5), (0.5, 1)):
        a, b = np.random.default_rng(9), np.random.default_rng(9)
        got = [sample_host(row, temp, top_k, a) for row in logits]
        want = [ref_sample_host(row, temp, top_k, b) for row in logits]
        assert got == want


def test_sample_tokens_draws_from_the_top_k_support():
    rng = np.random.default_rng(6)
    B, V, k_max = 6, 50, 8
    logits = rng.standard_normal((B, V)).astype(np.float32) * 2
    temp = np.array([0.0, 0.7, 1.5, 0.7, 0.0, 2.0], np.float32)
    top_k = np.array([5, 3, 1, 60, 4, 10], np.int32)
    want_greedy = np.asarray(ref_sample_tokens(
        jnp.asarray(logits), jax.random.key(0), jnp.asarray(temp),
        jnp.asarray(top_k), k_max=k_max))
    gen = torch.Generator().manual_seed(0)
    order = np.argsort(-logits, axis=-1)
    seen = [set() for _ in range(B)]
    for _ in range(200):
        tok = sample_tokens(torch.tensor(logits), gen, torch.tensor(temp),
                            torch.tensor(top_k), k_max=k_max).numpy()
        assert tok.dtype == np.int32
        for b in range(B):
            if temp[b] <= 0:
                assert tok[b] == want_greedy[b] == np.argmax(logits[b])
            else:
                k = min(max(int(top_k[b]), 1), k_max)
                assert tok[b] in set(order[b, :k])
            seen[b].add(int(tok[b]))
    assert seen[2] == {int(order[2, 0])}            # top_k 1
    assert len(seen[5]) > 1                          # really sampled


def test_launcher_serves_on_the_cpu_and_defers_what_is_not_ported(capsys,
                                                                  tmp_path):
    """The launcher serves seeded weights, the int8 KV cache, and (since
    training is ported) a checkpoint's parameters with `--ckpt-dir`."""
    assert serve.main(["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu",
                       "--requests", "3", "--max-new", "4", "--stats"]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests / 12 tokens" in out and "[telemetry]" in out
    assert serve.main(["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu",
                       "--requests", "3", "--max-new", "4", "--kv-dtype",
                       "int8"]) == 0
    assert "served 3 requests / 12 tokens" in capsys.readouterr().out
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.launch.steps import build_train
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                              name="qwen2-0.5b", dtype="float32")
    save_checkpoint(str(tmp_path), 5, build_train(cfg).init_state(
        Model(cfg, device="cpu", seed=5)))
    assert serve.main(["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu",
                       "--requests", "3", "--max-new", "4",
                       "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "restored params from step 5" in out
    assert "served 3 requests / 12 tokens" in out


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "zamba2-2.7b",
                                  "xlstm-1.3b", "whisper-large-v3",
                                  "internvl2-1b"])
def test_launcher_serves_the_moe_and_hybrid_families(arch, capsys):
    assert serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--requests", "3", "--max-new", "5"]) == 0
    assert "served 3 requests / 15 tokens" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the moe and hybrid families and the int8 KV cache through the engine
# ---------------------------------------------------------------------------

# (arch, config overrides, prompt lengths): reduced mixtral's prompts are
# longer than its 32-token window (prefill seeds the ring with S > W and
# decode wraps it); zamba2's are any length up to one 256-token chunk
FAMILY_SERVES = {
    "mixtral": ("mixtral-8x7b", {}, (40, 40, 36, 40, 36)),
    "zamba2": ("zamba2-2.7b", {}, (6, 6, 9, 6, 9)),
    "llama-int8": ("llama3.2-1b", {"kv_dtype": "int8"}, PROMPT_LENS),
    "xlstm": ("xlstm-1.3b", {}, (6, 6, 9, 2, 9)),
    "whisper": ("whisper-large-v3", {}, PROMPT_LENS),
    "internvl2": ("internvl2-1b", {}, (6, 6, 9, 6, 38)),
}


@pytest.fixture(scope="module", params=list(FAMILY_SERVES))
def family(request):
    arch, over, lens = FAMILY_SERVES[request.param]
    ref_cfg = dataclasses.replace(ref_get_config(arch).reduced(),
                                  dtype="float32", **over)
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              **over)
    params = RefModel(ref_cfg).init(jax.random.key(0))
    model = interop.model_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params), device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    return ref_cfg, params, cfg, model, prompts


@pytest.mark.parametrize("mode", ["device", "host"])
def test_family_greedy_streams_match_reference(family, mode):
    """Greedy streams equal to the reference engine's with the same
    admission order: capacity drops depend on the batch (prefill counts
    the edge-repeated pad rows, decode every slot), so each side serves
    the same stream of batches."""
    ref_cfg, params, cfg, model, prompts = family
    kw = dict(n_slots=N_SLOTS, window=48, mode=mode, decode_chunk=CHUNK)
    want = _serve(RefEngine(ref_cfg, params, **kw), RefRequest, prompts)
    eng = ServeEngine(cfg, model, **kw)
    got = _serve(eng, Request, prompts)
    assert got == want
    assert all(len(t) == MAX_NEW for t in got.values())
    assert eng.window == (cfg.sliding_window or 48)


def test_engine_serves_only_a_port_model():
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                              dtype="float32")
    with pytest.raises(TypeError):
        ServeEngine(cfg, {"embed": np.zeros(3)})
    with pytest.raises(ValueError):
        ServeEngine(cfg, Model(cfg, device="cpu"), mode="batch")


def test_vlm_positions_count_the_patches(family):
    """The vlm family's prefill puts its patches before the prompt, so a
    slot's pos and its host-tracked context both start at n_patches +
    len(prompt), in both modes; other families' at len(prompt)."""
    ref_cfg, params, cfg, model, prompts = family
    n_p = cfg.n_patches if cfg.family == "vlm" else 0
    for mode in ("device", "host"):
        eng = ServeEngine(cfg, model, n_slots=N_SLOTS, window=48, mode=mode,
                          decode_chunk=CHUNK)
        for i, p in enumerate(prompts[:N_SLOTS]):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=MAX_NEW))
        eng._admit()
        want = [len(p) + n_p for p in prompts[:N_SLOTS]]
        if cfg.family != "ssm":
            assert eng._ctx == want
        assert eng.pos.tolist() == want


def test_window_rule(family):
    """A request writes n_patches + prompt + max_new - 1 cache rows (the
    last token emitted is never fed back): one that fills the window
    exactly is served, token for token as the reference engine serves it
    (chunked decode, so the finished slot's frozen steps run too), and
    one more prompt or new token is refused at submit, naming the rule.
    A ring cache and the ssm family's state take any length."""
    ref_cfg, params, cfg, model, _ = family
    W = 24
    kw = dict(n_slots=N_SLOTS, window=W, decode_chunk=CHUNK)
    eng = ServeEngine(cfg, model, **kw)
    if not model.rows_bounded:
        eng.submit(Request(rid=0, prompt=np.zeros(40, np.int32),
                           max_new_tokens=8))
        assert len(eng.queue) == 1
        return
    rng = np.random.default_rng(2)
    fits = rng.integers(0, cfg.vocab_size,
                        W - model.prefix_rows - MAX_NEW + 1).astype(np.int32)
    got = _serve(eng, Request, [fits])
    assert got == _serve(RefEngine(ref_cfg, params, **kw), RefRequest, [fits])
    assert len(got[0]) == MAX_NEW
    for prompt, max_new in ((np.append(fits, 0), MAX_NEW),
                            (fits, MAX_NEW + 1)):
        with pytest.raises(ValueError,
                           match="n_patches \\+ prompt \\+ max_new"):
            eng.submit(Request(rid=1, prompt=prompt, max_new_tokens=max_new))
    assert not eng.queue
