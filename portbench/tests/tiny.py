"""Cells at a size a CPU test run holds: the configurations' shapes cut
to a few units, the traffic mixes' loops cut to a few items."""

from __future__ import annotations

import copy

from portbench import harness

SEED = 2 ** 31 + 12345

DENSE_CUT = {"num_hidden_layers": 2, "hidden_size": 64,
             "num_attention_heads": 4, "num_key_value_heads": 2,
             "head_dim": 16, "intermediate_size": 128, "vocab_size": 300}
MAMBA_CUT = {"num_hidden_layers": 2, "hidden_size": 64, "head_dim": 16,
             "state_size": 16, "chunk_size": 16, "vocab_size": 300}
MIX_CUT = {"train": {"batch": 2, "seq": 48, "trace_items": 1},
           "prefill": {"cycle": [[32, 2], [64, 1]], "checked_requests": 2,
                       "batch": 2},
           "decode": {"batch": 4, "cache_len": 4096, "positions": [32, 64],
                      "swap_every": 4, "warmup_steps": 2,
                      "checked_sequences": 2}}
# limits of the tiny cells: their own sound runs read under them
TINY_LIMITS = {"train": {"loss_gap": 0.002, "grad_dist": 0.08,
                         "grad_median_dist": 0.05, "change_dist": 0.3},
               "prefill": {"token_gap": 0.05}, "decode": {"token_gap": 0.05}}


def spec(config: str, dtype: str = "bfloat16") -> dict:
    manifest = harness.load_manifest()
    out = copy.deepcopy(harness.config_spec(manifest, config))
    out.update(DENSE_CUT if out["family"] == "dense" else MAMBA_CUT)
    out["torch_dtype"] = dtype
    return out


def mix(traffic: str) -> dict:
    out = copy.deepcopy(harness.traffic_mix(traffic))
    out.update(MIX_CUT[out["kind"]])
    return out


def context(workload: str, dtype: str = "bfloat16", seed: int = SEED,
            limits=None):
    import torch

    from portbench.run import Context
    manifest = harness.load_manifest()
    cell = harness.entry(manifest["workloads"], workload)
    m = mix(cell["traffic"])
    return Context(workload, spec(cell["config"], dtype), m, seed,
                   torch.device("cpu"),
                   TINY_LIMITS[m["kind"]] if limits is None else limits)


def run(workload: str, seconds: float = 0.5, **kw) -> dict:
    """One tiny run of a cell on the CPU, with the look for a card
    skipped."""
    from portbench.run import run_cell
    return run_cell(context(workload, **kw), seconds, False,
                    [{"name": "setup_s", "unit": "s"}])
