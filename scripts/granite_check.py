#!/usr/bin/env python3
"""granite-4.0-h-small on one card, outside the benchmark's cells.

- ``serve``: the benchmark's configuration (one period, 9 of 72 experts
  held) at its published widths with seeded weights: a prefill of
  ``--batch`` prompts against the plain reference's logits; then a
  ``ServeDriver`` fed the same prompts a token at a time and decoding
  greedily (its step replayed from a CUDA graph), every served token
  against the reference's full forward of the sequence it served; then a
  ``hot_swap`` to a second weight set, the driver's cache cleared in
  place, and new prompts decoded under the new weights the same way (and
  held against the old weights' reference, which they must miss). The
  driver's logits are copied out of its own step (captured with it).
- ``routes``: on the training cell's first batch, how many of each MoE
  layer's assignments the float32 reference routes to other experts than
  the bf16 program.

    python3 scripts/granite_check.py [--phase serve routes] \
        [--seed 7]

Prints one JSON line a phase; exits non-zero where a check fails.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def _gaps(logits, served):
    """By how much each served token's logit lies below the best."""
    pick = logits.gather(-1, served[..., None].long())[..., 0]
    return logits.max(-1).values - pick


def serve_phase(seed: int, batch: int, prompt: int, steps: int) -> dict:
    import torch

    from portbench import harness, weights
    from portbench.program import port_config
    from portbench.reference import granite_hybrid as fam
    from portbench.reference.common import exact_float32
    from repro_torch.serving.predictor import ServeDriver, make_prefill_step
    dev = torch.device("cuda")
    spec = harness.config_spec(harness.load_manifest(), "granite-4.0-h-small")
    cfg = port_config(spec)
    sets = [weights.make_params(spec, seed, dev, "bfloat16", tag=tag)
            for tag in ("", "swap/")]
    ids = [torch.from_numpy(weights.zipf_ids(
        seed, f"granite/serve/{i}", batch * prompt, spec["vocab_size"],
        1.0).reshape(batch, prompt)).to(dev) for i in range(2)]

    @torch.no_grad()
    def reference(tag: str, tokens):
        with exact_float32():
            params = weights.make_params(spec, seed, dev, "float32", tag=tag)
            return fam.head(params, spec, fam.hidden(params, spec, tokens,
                                                     "float32"), "float32")

    out: dict = {}
    with torch.inference_mode():
        got = make_prefill_step(cfg)(sets[0], {"tokens": ids[0]}).float()
    want = reference("", ids[0])
    v = spec["vocab_size"]
    out["prefill"] = {
        "max_abs_err": float((got[..., :v] - want).abs().max()),
        "ref_abs_max": float(want.abs().max()),
        "token_gap": float(_gaps(want, got[..., :v].argmax(-1)).max())}
    driver = ServeDriver(cfg, sets[0], batch=batch,
                         max_len=prompt + steps + 1,
                         cache_dtype=torch.bfloat16, device=dev)
    # the driver's own step, its logits also copied into a buffer (made at
    # the eager first step, written by the capture and every replay)
    inner, kept = driver.step_fn, {}

    def step_fn(params, cache, tokens, pos):
        logits, cache = inner(params, cache, tokens, pos)
        kept.setdefault("logits", torch.empty_like(logits)).copy_(logits)
        return logits, cache

    driver.step_fn = driver._own_step = step_fn
    for phase, (tag, n_steps) in enumerate((("", steps),
                                            ("swap/", steps // 2))):
        if phase:
            driver.hot_swap(sets[1])
            for t in torch.utils._pytree.tree_leaves(driver.cache):
                t.zero_()
            driver.pos.zero_()
        served, logits = [], []
        with torch.inference_mode():
            for i in range(prompt + n_steps):
                fed = ids[phase][:, i:i + 1] if i < prompt else tok
                tok = driver.step(fed).clone()
                served.append(tok[:, 0])
                logits.append(kept["logits"][:, :v].float())
        seq = torch.cat([ids[phase], torch.stack(served[prompt - 1:-1], 1)],
                        dim=1)
        served, logits = torch.stack(served, 1), torch.stack(logits, 1)
        own = reference(tag, seq)
        other = reference("swap/" if not phase else "", seq)
        out[f"decode_{phase}"] = {
            "weights": tag or "first", "steps": int(seq.shape[1]),
            "max_abs_err": float((logits - own).abs().max()),
            "max_abs_err_other_weights": float((logits - other).abs().max()),
            "ref_abs_max": float(own.abs().max()),
            "token_gap": float(_gaps(own, served).max()),
            "graph": driver._graph is not None}
    # the driver's logits lie near its own weights' reference, far from
    # the other weights' (a tenth of the other's error at most)
    out["ok"] = all(out[f"decode_{p}"]["graph"]
                    and out[f"decode_{p}"]["max_abs_err"]
                    < 0.1 * out[f"decode_{p}"]["max_abs_err_other_weights"]
                    for p in (0, 1))
    return out


def routes_phase(seed: int) -> dict:
    """How many of the training cell's first-step assignments the float32
    reference routes to other experts than the bf16 program, layer by
    layer (each side's own layer inputs)."""
    import torch

    from portbench import harness, weights
    from portbench.program import port_config
    from portbench.reference import granite_hybrid as fam
    from portbench.reference.common import exact_float32
    from repro_torch.models import forward
    from repro_torch.models import moe as moe_lib
    dev = torch.device("cuda")
    spec = harness.config_spec(harness.load_manifest(), "granite-4.0-h-small")
    mix = harness.traffic_mix("train-8x2048")
    b, s = mix["batch"], mix["seq"]
    tokens = torch.from_numpy(weights.zipf_ids(
        seed, "train/0", b * s, spec["vocab_size"],
        mix["zipf_exponent"]).reshape(b, s)).to(dev)
    got, want = [], []
    route, ref_route = moe_lib.route, fam.route

    def record(into, fn):
        def wrapped(*args):
            res = fn(*args)
            into.append(res[0])
            return res
        return wrapped

    moe_lib.route = record(got, route)
    fam.route = record(want, ref_route)
    try:
        with torch.no_grad():
            params = weights.make_params(spec, seed, dev, "bfloat16")
            forward(params, port_config(spec), tokens)
            del params
            with exact_float32():
                params = weights.make_params(spec, seed, dev, "float32")
                for r in range(b):
                    fam.hidden(params, spec, tokens[r:r + 1], "float32")
    finally:
        moe_lib.route, fam.route = route, ref_route
    layers = len(got)
    want = [torch.cat(want[i::layers]) for i in range(layers)]
    experts = spec["published_num_local_experts"]
    differ = []
    for g, w in zip(got, want):
        hot = torch.zeros((g.shape[0], experts), dtype=torch.bool,
                          device=dev)
        hot.scatter_(1, w, True)
        differ.append(int((~hot.gather(1, g)).sum()))
    total = got[0].numel()
    return {"assignments_a_layer": total, "differ_by_layer": differ,
            "differ_share": sum(differ) / (total * layers),
            "ok": True}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", nargs="+", default=["serve", "routes"],
                    choices=["serve", "routes"])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=192)
    ap.add_argument("--steps", type=int, default=64)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("granite_check: no CUDA card", file=sys.stderr)
        return 3
    ok = True
    for phase in args.phase:
        if phase == "serve":
            res = serve_phase(args.seed, args.batch, args.prompt, args.steps)
        else:
            res = routes_phase(args.seed)
        res = {"phase": phase, "card": torch.cuda.get_device_name(0), **res}
        print(json.dumps(res), flush=True)
        ok &= res["ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
