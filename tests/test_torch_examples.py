"""The port's fault-tolerance examples run end to end on the CPU, as
subprocesses at a small size: ``examples/fault_tolerance_demo_torch.py``
(hot failover, partial cold recovery, the domino downgrade) and
``examples/reshard_migration_torch.py`` (a 10 → 20 shard migration,
bit-identical across it)."""

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
