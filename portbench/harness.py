"""Shared machinery of the port's benchmark: the manifest and the files
found by the names it gives, the device check, the import check and the
result line.

Nothing here imports the program; ``run.py`` puts ``src/`` on the path
before a cell's driver imports ``repro_torch``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

# top-level module names that may not be loaded in a benchmark process:
# the JAX stack and the JAX package the port was made from
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """Wall-clock time at which this process started (Linux: from
    ``/proc``; elsewhere the time of this call)."""
    try:
        stat = Path("/proc/self/stat").read_text()
        ticks = int(stat.rsplit(")", 1)[1].split()[19])
        for line in Path("/proc/stat").read_text().splitlines():
            if line.startswith("btime "):
                return int(line.split()[1]) + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        pass
    return time.time()


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def entry(entries: list, name: str) -> dict:
    """The entry of ``entries`` whose ``name`` is ``name``."""
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no entry named {name!r}; known: "
                   f"{[e['name'] for e in entries]}")


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def config_spec(manifest: dict, name: str, root: Path = ROOT) -> dict:
    """The configuration's file of sizes, as the manifest names it."""
    return load_json(root / entry(manifest["configs"], name)["file"])


def traffic_mix(name: str) -> dict:
    """``traffic/<name>.json``: the parameters of a traffic mix."""
    return load_json(BENCH / "traffic" / f"{name}.json")


def limits(workload: str) -> dict:
    """``limits/<workload>.json``: each compared number's limit."""
    return load_json(BENCH / "limits" / f"{workload}.json")["limits"]


def kind_module(kind: str):
    """``kinds/<kind>.py``: the driver of a traffic mix's kind."""
    return importlib.import_module(f"portbench.kinds.{kind}")


def family_module(family: str):
    """``reference/<family>.py``: a model family's plain reference and
    its operation counts."""
    return importlib.import_module(f"portbench.reference.{family}")


def _reader(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``; for a name ``<base>.<kind>``
    with no file of its own, ``metrics/<base>.py``'s, read only in a cell
    of that kind (one reader for a quantity split by the end-to-end
    metric its kinds report)."""
    path = BENCH / "metrics" / f"{name}.py"
    if path.exists():
        return _reader(path, name)
    base, _, kind = name.rpartition(".")
    read = _reader(BENCH / "metrics" / f"{base}.py", base)
    return lambda cell: (read(cell) if getattr(cell, "kind", None) == kind
                         else None)


def cell_metrics(manifest: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: with ``trace`` the
    per-layer ones that list it (or, without a ``workloads`` key, move
    an end-to-end metric it reports), else its end-to-end ones."""
    e2e = [m for m in manifest["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if workload in m.get("workloads", [workload])
            and m["moves"] in names]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is forbidden, compared whole
    (``repro_torch`` is not ``repro``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0..100) of ``values``, linear between
    order statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def limited(values: dict, limits: dict) -> dict:
    """``{name: {"value", "limit"}}``: each compared number (each that
    ``limits`` names) beside its limit."""
    missing = sorted(set(limits) - set(values))
    if missing:
        raise KeyError(f"limits name numbers the check does not read: "
                       f"{missing}")
    return {k: {"value": values[k], "limit": limits[k]} for k in limits}


def all_within(checks: dict) -> bool:
    """Every compared number is finite and at most its limit."""
    return all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
               for v in checks.values())


def spread_line(name: str, times: list) -> str:
    """Order statistics of a window's per-item times, for the log."""
    xs = sorted(times)
    q = {p: percentile(xs, p) for p in (50, 90, 95, 99)}
    return (f"{name} {len(xs)}: min {xs[0]:.4f} s, p50 {q[50]:.4f}, p90 "
            f"{q[90]:.4f}, p95 {q[95]:.4f}, p99 {q[99]:.4f}, max "
            f"{xs[-1]:.4f}")
