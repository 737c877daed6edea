"""The port's dry-run (``launch/dryrun.py``) on the CPU: fake process
groups, fake tensors on ``cpu`` meshes.

Held: ``run_pair`` on reduced qwen2-1.5b, granite-moe-3b-a800m and
mamba2-1.3b on a fake (2, 2) mesh for a train, a prefill and a decode
shape (small ones) returns ``ok`` with the reference's result keys,
written to its JSON; a ``long_500k`` pair for qwen2-1.5b returns
``skip`` with the reference's reason; ``local_pass`` counts the same
FLOPs, bytes and ops on real CPU tensors (the kernels' plain versions
behind their custom ops) as on fake ones, for a reduced prefill and
train step; importing the dry-run sets no environment variable and
creates no process group; each call leaves no group behind. The same
real-vs-fake equality on the card, for qwen2-1.5b at full width, is
``test_torch_cuda.py``'s (a file without JAX).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch.distributed as dist

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import applicable as jax_applicable
from repro.configs import get_config as jax_get_config
from repro_torch.configs import InputShape, get_config, reduced
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_analysis import count_ops

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen2-1.5b", "granite-moe-3b-a800m", "mamba2-1.3b"]
SMALL = {"train": InputShape("train_4k", 64, 8, "train"),
         "prefill": InputShape("prefill_32k", 128, 4, "prefill"),
         "decode": InputShape("decode_32k", 256, 8, "decode")}

# the reference's ``analyze`` + ``run_pair`` result, key by key
RESULT_KEYS = {"devices", "compile_seconds", "memory", "cost",
               "collectives", "roofline", "arch", "shape", "mesh", "status",
               "lower_seconds"}
NESTED_KEYS = {
    "memory": {"argument_bytes_per_device", "output_bytes_per_device",
               "temp_bytes_upper_bound", "activation_estimate"},
    "cost": {"flops_per_device", "flops_global", "bytes_per_device",
             "bytes_global", "scan_correction"},
    "collectives": {"counts", "operand_bytes", "result_bytes",
                    "total_operand_bytes", "scan_corrected_operand_bytes",
                    "scan_corrected_counts"},
    "roofline": {"compute_s", "memory_s", "collective_s",
                 "memory_s_xla_upper_bound", "hbm_bytes_est_per_device",
                 "dominant", "model_flops", "useful_flops_ratio"},
}


@pytest.fixture(autouse=True)
def no_group_left():
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():           # a failed test's group
        dist.destroy_process_group()
        pytest.fail("a process group was left behind")


@pytest.mark.parametrize("kind", sorted(SMALL))
@pytest.mark.parametrize("arch", ARCHS)
def test_run_pair_ok_with_reference_keys(tmp_path, arch, kind):
    shape = SMALL[kind]
    r = dryrun.run_pair(arch, shape.name, multi_pod=False,
                        out_dir=str(tmp_path), verbose=False,
                        device_type="cpu", cfg=reduced(get_config(arch)),
                        mesh_shape=(2, 2), shape=shape)
    assert r["status"] == "ok", r.get("traceback")
    assert set(r) == RESULT_KEYS
    for key, sub in NESTED_KEYS.items():
        assert set(r[key]) == sub, key
    assert r["devices"] == 4 and r["mesh"] == "pod1"
    assert r["cost"]["flops_per_device"] > 0
    assert r["roofline"]["dominant"] in ("compute_s", "memory_s",
                                         "collective_s")
    with open(tmp_path / f"{arch}__{shape.name}__pod1.json") as f:
        assert json.load(f)["status"] == "ok"


def test_long_context_skip_has_reference_reason():
    r = dryrun.run_pair("qwen2-1.5b", "long_500k", multi_pod=True,
                        out_dir=None, verbose=False, device_type="cpu")
    ok, why = jax_applicable(jax_get_config("qwen2-1.5b"),
                             JAX_SHAPES["long_500k"])
    assert not ok
    assert r == {"arch": "qwen2-1.5b", "shape": "long_500k", "mesh": "pod2",
                 "status": "skip", "reason": why}


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_local_pass_real_counts_equal_fake(kind):
    cfg = reduced(get_config("qwen2-1.5b"))
    r = dryrun.local_pass(cfg, InputShape("x", 64, 4, kind),
                          device_type="cpu")
    assert r["real"].flops_per_device > 0
    assert r["real"] == r["fake"]
    assert r["real_mode"].op_counts == r["fake_mode"].op_counts
    assert count_ops(r["real_mode"], ("repro_torch.flash_attention",
                                      "aten.no_such_op")) == \
        {"repro_torch.flash_attention": 1}


def test_import_sets_no_env_and_no_group():
    script = ("import os, sys; sys.path.insert(0, 'src'); "
              "before = dict(os.environ); "
              "import repro_torch.launch.dryrun, repro_torch.launch.cost_model; "
              "import torch.distributed as dist; "
              "assert dict(os.environ) == before; "
              "assert not dist.is_initialized(); print('ok')")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={k: v for k, v in os.environ.items()
                              if k != "XLA_FLAGS"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
