"""The port stands alone: it imports neither ``jax`` nor the JAX package
``repro``. Every module under ``src/repro_torch/`` and ``chip_smoke.py``
must import in a fresh interpreter where both are made unimportable,
and no import statement anywhere in them or in the port's examples
(``examples/*_torch.py``) — those inside functions included — may name
either."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_SCRIPT = """
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any import of jax or repro now raises
sys.modules["repro"] = None
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
print(" ".join(names))
"""

# the modules of each slice, which must be among those imported
SLICE_MODULES = {
    "repro_torch.core.sync_engine", "repro_torch.core.tree",
    "repro_torch.data", "repro_torch.data.streams",
    "repro_torch.launch.train", "repro_torch.training.trainer",
    "repro_torch.launch.serve", "repro_torch.models.model",
    "repro_torch.kernels.embedding_lookup", "repro_torch.core.streaming",
    "repro_torch.core.cluster", "repro_torch.core.downgrade",
    "repro_torch.core.fault_tolerance", "repro_torch.core.queue",
    "repro_torch.core.scheduler", "repro_torch.data.joiner",
    "repro_torch.training.pipeline", "repro_torch.training.scheduler",
    "repro_torch.optim.optimizers", "repro_torch.obs.perfetto",
    "repro_torch.convert",
    "repro_torch.launch.transport", "repro_torch.launch.chaos",
    "repro_torch.launch.mesh", "repro_torch.launch.specs",
    "repro_torch.launch.worker", "repro_torch.launch.runtime",
    "repro_torch.launch.slo", "repro_torch.models.moe",
    "repro_torch.configs.granite_moe_3b_a800m",
    "repro_torch.configs.dbrx_132b",
    "repro_torch.models.ssm", "repro_torch.configs.mamba2_1_3b",
    "repro_torch.configs.gemma3_4b",
    "repro_torch.configs.whisper_medium",
    "repro_torch.configs.llama_3_2_vision_90b",
    "repro_torch.configs.shapes", "repro_torch.models.sharding",
    "repro_torch.launch.dryrun", "repro_torch.launch.cost_model",
    "repro_torch.launch.hlo_analysis",
}


def test_port_and_smoke_import_without_jax_or_repro():
    script = _SCRIPT.format(src=str(ROOT / "src"), root=str(ROOT))
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 40                         # every port module
    assert SLICE_MODULES <= names


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_import_statement_names_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + sorted(
        (ROOT / "examples").glob("*_torch.py"))
    bad = {str(f.relative_to(ROOT)): sorted(r & {"jax", "repro"})
           for f in files if (r := _imported_roots(f)) & {"jax", "repro"}}
    assert not bad
