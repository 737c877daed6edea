"""Lazy ``nvcc`` build of the port's CUDA sources.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/repro_torch/lib<name>-<digest>.so`` under the checkout root
(the digest covers the source and the flags, so an edited source never
loads a stale library), at first use, and is loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o lib<name>-<digest>.so <name>.cu

Nothing here runs at import, so ``import repro_torch`` works on a host
with no CUDA toolkit; asking for a kernel there raises ``RuntimeError``.
The wrappers share ``on_cpu`` (device dispatch) and ``launch`` (stream,
device guard and launch-error check) from here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("hashmap_probe", "embedding_lookup")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """Path of the CUDA compiler: ``nvcc`` on PATH, else under
    ``$CUDA_HOME`` (default ``/usr/local/cuda``)."""
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return path


def library_path(name: str) -> Path:
    """Where the built library for ``csrc/<name>.cu`` lives."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every named source whose library is missing, one ``nvcc``
    process per source, all started together. Returns ``{name: compiler
    output}`` for the sources compiled (``-Xptxas -v`` prints registers,
    shared memory and spills per kernel). Raises ``RuntimeError`` naming
    each source that failed, with its compiler output."""
    jobs = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, so)
    logs, failed = {}, []
    for name, (proc, tmp, so) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, so)         # atomic: concurrent builds agree
        else:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n"
                          f"{logs[name]}")
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the wrapper runs the plain
    version), False when all lie on one CUDA device (it launches the
    kernel); raises ``ValueError`` for anything else — never a silent
    fallback."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError("tensors on " + ", ".join(str(t.device)
                                                   for t in tensors)
                         + ": all must be on the CPU or on one CUDA device")
    return False


def launch(name: str, cfunc, device: torch.device, *args) -> None:
    """Call a library entry point on ``device``'s current stream (passed
    last); raise ``RuntimeError`` if it reports a launch error."""
    with torch.cuda.device(device):
        rc = cfunc(*args, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
