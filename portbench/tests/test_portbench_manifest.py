"""``BENCHMARK.json`` against the benchmark's contract, the files it
names by name, and the operation and byte counts against the figures
measured before (``PERF.md``)."""

import re

import pytest

from portbench import harness, peaks
from portbench.reference import dense

M = harness.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|"
                   r"expand|_dim$|_rank$|experts_per_tok|num_experts_per)")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in M["workloads"]]


def _one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_limits():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["command"] == ["python3", "portbench/run.py"]
    assert all(_one_line(w) for w in M["command"]) and len(M["command"]) <= 32
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert isinstance(M["run_seconds"], int) and 10 <= M["run_seconds"] <= 51
    # a full check of 24 cells: 2 + 14 x 24 runs, 2 x 90 s of compile a cell
    need = (2 + 14 * 24) * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert need <= 43200
    assert 1 <= len(M["configs"]) <= 24 and 1 <= len(M["workloads"]) <= 24
    assert 1 <= len(M["end_to_end"]) <= 16 and 1 <= len(M["per_layer"]) <= 128


def test_names_units_and_keys():
    names = {"configs": set(), "workloads": set(), "metrics": set()}
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _one_line(c["why"])
        assert _one_line(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTH.search(k) for k in c["reduced"])
        names["configs"].add(c["name"])
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] == 1 and _one_line(w["why"])
        assert w["config"] in names["configs"]
        names["workloads"].add(w["name"])
    assert len(names["workloads"]) == len(M["workloads"])
    assert len(names["configs"]) == len(M["configs"])
    assert len({(w["config"], w["traffic"]) for w in M["workloads"]}) \
        == len(M["workloads"])
    for m in M["end_to_end"] + M["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert set(m.get("workloads", [])) <= names["workloads"]
        names["metrics"].add(m["name"])
    assert len(names["metrics"]) == len(M["end_to_end"]) + len(M["per_layer"])
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _one_line(m["layer"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_and_a_layer():
    for w in CELLS:
        e2e = {m["name"] for m in harness.cell_metrics(M, w, False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(M, w, True), w


def test_each_layer_metric_moves_an_end_to_end_metric_its_cells_report():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    for m in M["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for w in m.get("workloads", CELLS):
            assert w in e2e[m["moves"]].get("workloads", CELLS), (m, w)


@pytest.mark.parametrize("workload", CELLS)
def test_files_resolve_by_name(workload):
    w = harness.entry(M["workloads"], workload)
    spec = harness.config_spec(M, w["config"])
    entry = harness.entry(M["configs"], w["config"])
    assert entry["file"].startswith(tuple(p + "/" for p in M["paths"]))
    assert spec["name"] == w["config"] and spec["reduced"] == entry["reduced"]
    assert spec["source"] == entry["source"]
    mix = harness.traffic_mix(w["traffic"])
    assert hasattr(harness.kind_module(mix["kind"]), "Cell")
    fam = harness.family_module(spec["family"])
    for fn in ("forward_flops", "train_flops", "loss_and_grads", "hidden",
               "head"):
        assert callable(getattr(fam, fn))
    limits = harness.limits(workload)
    assert limits and all(v > 0 for v in limits.values())
    for m in harness.cell_metrics(M, workload, True):
        assert callable(harness.metric_reader(m["name"]))


def test_port_config_takes_the_files_sizes():
    from portbench.program import port_config
    from repro_torch.configs import get_config
    for c in M["configs"]:
        spec = harness.config_spec(M, c["name"])
        cfg = port_config(spec)
        assert cfg == get_config(spec["port_arch"]), c["name"]
        assert cfg.num_layers == spec["num_hidden_layers"]


QWEN = harness.config_spec(M, "qwen2-1.5b")


def test_prefill_model_flops_match_the_dry_run():
    """4 x 2048 prefill: the dense part is 25.6 ms of model FLOPs at the
    bf16 peak, the whole the 2.67369e13 FLOPs the dry-run counts for the
    same step (PERF.md)."""
    whole = dense.forward_flops(QWEN, 4, 2048)
    attn = 2.0 * 4 * 12 * 2048 ** 2 * 128 * 28
    assert (whole - attn) / peaks.BF16_FLOPS * 1e3 == pytest.approx(25.6,
                                                                    abs=0.05)
    assert whole == pytest.approx(2.67369e13, rel=1e-3)


def test_flash_bound_matches_row_9():
    """Row 9: (4, 12, 2048, 128) against (4, 2, 2048, 128), bf16, causal:
    0.05211 ms, bound by operations."""
    flops, nbytes = dense.flash_flops_bytes(4, 12, 2, 2048, 128)
    assert flops / peaks.BF16_FLOPS > nbytes / peaks.HBM_BYTES_PER_S
    assert peaks.least_s(flops, nbytes) * 1e3 == pytest.approx(0.05211,
                                                               rel=1e-3)


def test_decode_bound_matches_row_10():
    """Row 10: q (4, 12, 128) bf16 against a float32 (4, 4096, 2, 128)
    cache at 4,001 rows: 0.00979 ms, bound by bytes."""
    nbytes = dense.decode_attention_bytes([4001] * 4, 12, 2, 128, 4, 2, 2)
    assert nbytes / peaks.HBM_BYTES_PER_S * 1e3 == pytest.approx(0.00979,
                                                                 abs=5e-6)


def test_train_flops_are_three_forwards():
    assert dense.train_flops(QWEN, 4, 2048) == pytest.approx(
        3 * dense.forward_flops(QWEN, 4, 2048))
    assert dense.decode_flops(QWEN, [1] * 4) == pytest.approx(
        2 * 4 * dense.matmul_params(QWEN) + 4 * 4 * 12 * 128 * 28)
