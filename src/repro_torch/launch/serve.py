"""Serving launcher (port of `repro.launch.serve`): initializes seeded
weights, starts the slot-based continuous-batching engine and serves a
synthetic request stream. Decode stays on the device by default:
`--decode-chunk K` runs K decode+sample steps per host sync;
`--host-loop` takes the per-token reference loop; `--kv-dtype int8`
quantizes the KV cache after prefill (dense, vlm and moe archs without
a sliding window). Serves every arch: dense, vlm (internvl2-1b, its 256
stub patch embeddings before each prompt), moe (mixtral-8x7b,
arctic-480b), hybrid (zamba2-2.7b), ssm (xlstm-1.3b) and audio
(whisper-large-v3, its 1500 stub encoder frames). The synthetic prompts
are 4-31 tokens, so they meet the Mamba2 and mLSTM rule (a prompt longer
than 256 tokens must be a multiple of 256); a request must fit the cache
window (n_patches + prompt + max_new - 1 <= --window, the rows it writes,
else the engine raises). `--ckpt-dir` serves the parameters of the
newest committed training checkpoint there (its float32 master cast to
each weight's working dtype) in place of the seeded ones. Requests
alternate greedy and temperature 0.7 (`--greedy`: all greedy);
`--output` writes each request's tokens as JSON lines {"rid", "tokens"}.
Runs on the card unless `--device cpu` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        [--reduced] [--device cpu] [--slots 4] [--window 1024] \\
        [--decode-chunk 8] [--host-loop] [--kv-dtype int8] [--stats]
        [--ckpt-dir DIR] [--greedy] [--output FILE]
"""
from __future__ import annotations

import argparse
import dataclasses
import time


def model_from_checkpoint(cfg, ckpt_dir, device="cuda"):
    """(step, Model) holding the parameters of the newest committed
    training checkpoint in `ckpt_dir` (its "params/..." leaves, cast to
    each weight's working dtype), or (None, None) if there is none."""
    from repro_torch import interop
    from repro_torch.checkpoint import latest_step, restore_checkpoint
    from repro_torch.models.model import Model

    step = latest_step(ckpt_dir)
    if step is None:
        return None, None
    like = {"params": interop.param_tree(Model(cfg, device="meta"))}
    tree = restore_checkpoint(ckpt_dir, step, like, device=device)
    return step, interop.model_params_from_numpy(cfg, tree["params"],
                                                 device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--window", type=int, default=1024)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--decode-chunk", type=int, default=8,
                    help="tokens generated per host sync (device mode)")
    ap.add_argument("--host-loop", action="store_true",
                    help="per-token host sampling loop (parity reference)")
    ap.add_argument("--kv-dtype", default=None, choices=[None, "int8"])
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore trained params from a checkpoint dir")
    ap.add_argument("--greedy", action="store_true",
                    help="every request greedy (default: odd rids sample "
                         "at temperature 0.7)")
    ap.add_argument("--output", default=None,
                    help="write each request's tokens as JSON lines")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    ap.add_argument("--stats", action="store_true",
                    help="attach the runtime telemetry collector and print "
                         "the window summary + per-request log")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving import ServeEngine
    from repro_torch.serving.engine import Request

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), name=cfg.name,
                                  dtype="float32")
    if args.kv_dtype:
        cfg = dataclasses.replace(cfg, kv_dtype=args.kv_dtype)
    step, model = (model_from_checkpoint(cfg, args.ckpt_dir, args.device)
                   if args.ckpt_dir else (None, None))
    if model is None:
        model = Model(cfg, device=args.device, seed=0)
    else:
        print(f"restored params from step {step}")

    collector = None
    if args.stats:
        from repro_torch.runtime import TelemetryCollector
        collector = TelemetryCollector()        # wall clock
    eng = ServeEngine(cfg, model, n_slots=args.slots, window=args.window,
                      mode="host" if args.host_loop else "device",
                      decode_chunk=args.decode_chunk, telemetry=collector)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        eng.submit(Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab_size,
                                rng.integers(4, 32)).astype(np.int32),
            max_new_tokens=args.max_new,
            temperature=0.7 if i % 2 and not args.greedy else 0.0))
    t0 = time.time()
    done, steps = eng.run()
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.time() - t0
    toks = sum(len(r.out_tokens) for r in done)
    if args.output:
        import json
        with open(args.output, "w") as f:
            for r in sorted(done, key=lambda r: r.rid):
                f.write(json.dumps({"rid": r.rid, "tokens": [
                    int(t) for t in r.out_tokens]}) + "\n")
    mode = "host-loop" if args.host_loop else \
        f"device chunk={eng.decode_chunk}"
    print(f"served {len(done)} requests / {toks} tokens in {steps} engine "
          f"steps / {dt:.2f}s ({toks/max(dt,1e-9):.1f} tok/s, "
          f"{eng.host_syncs} host syncs = "
          f"{toks/max(eng.host_syncs,1):.1f} tok/sync, {mode}, "
          f"{model.device})")
    if collector is not None:
        win = collector.snapshot()
        print(f"[telemetry] {win.decode_steps} decode steps, "
              f"mean batch {win.mean_batch:.2f}, "
              f"mean KV rows {win.mean_kv_rows:.1f}, "
              f"mean queue depth {win.mean_queue_depth:.2f}, "
              f"{win.prefill_tokens} prefill + {win.decode_tokens} decode "
              f"tokens over {win.duration_s:.2f}s")
        print(f"{'rid':>5} {'prompt':>7} {'emitted':>8} "
              f"{'queue_wait_s':>13} {'service_s':>10}")
        for st in sorted(eng.request_log, key=lambda s: s.rid):
            print(f"{st.rid:>5} {st.prompt_len:>7} {st.emitted:>8} "
                  f"{st.queue_wait_s:>13.4f} {st.service_s:>10.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
