"""The port's examples run end to end on the CPU, as subprocesses at a
small size: ``examples/fault_tolerance_demo_torch.py`` (hot failover,
partial cold recovery, the domino downgrade),
``examples/reshard_migration_torch.py`` (a 10 → 20 shard migration,
bit-identical across it), ``examples/serve_lm_torch.py`` (reduced
gemma3-4b decoding across hot swaps, its rings of 16 rows wrapping) and
``examples/train_lm_torch.py`` (reduced qwen2-1.5b trained, streamed and
decoded from the replica)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(script: str, *argv: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                          "--device", "cpu", *argv], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_fault_tolerance_demo_torch_on_cpu():
    out = _run("fault_tolerance_demo_torch.py", "--steps", "12")
    assert "device=cpu" in out
    assert "failed requests: 0; prediction drift after failover: 0.00e+00" \
        in out
    assert "shard 2 down: training pulls fail (as expected)" in out
    assert "domino downgrade fired" in out


@pytest.mark.parametrize("steps,batch", [(6, 64), (10, 128)])
def test_reshard_migration_torch_on_cpu(steps, batch):
    out = _run("reshard_migration_torch.py", "--steps", str(steps),
               "--batch", str(batch))
    assert "no rows lost" in out
    assert "values bit-identical across the 10->20 shard migration" in out
    assert "ownership verified" in out


def test_serve_lm_torch_on_cpu():
    out = _run("serve_lm_torch.py", "--decode-steps", "24",
               "--train-every", "8")
    assert "serving gemma3-4b-smoke" in out and "window=16" in out
    assert out.count("hot-swapped serve weights") == 3
    assert "generated (4, 24) tokens across 3 weight swaps" in out


def test_train_lm_torch_on_cpu():
    out = _run("train_lm_torch.py", "--steps", "6", "--batch", "4",
               "--seq", "32")
    assert "arch=qwen2-1.5b-smoke" in out and "device=cpu" in out
    assert "serve staleness:" in out
    assert "greedy decode from serve replica: shape=(4, 16)" in out
