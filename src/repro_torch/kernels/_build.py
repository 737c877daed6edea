"""Lazy ``nvcc`` build of the port's CUDA sources.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/repro_torch/lib<name>-<digest>.so`` under the checkout root
(the digest covers the source and the flags, so an edited source never
loads a stale library), at first use, and is loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o lib<name>-<digest>.so <name>.cu \\
         [EXTRA_FLAGS[name]]

(``flash_attention_sm90`` links ``-lcuda`` for ``cuTensorMapEncodeTiled``.)

Nothing here runs at import, so ``import repro_torch`` works on a host
with no CUDA toolkit; asking for a kernel there raises ``RuntimeError``.
The wrappers share ``on_cpu`` (device dispatch), ``launch`` (stream,
device guard and launch-error check), ``rows_aligned`` and
``DTYPE_CODES`` from here.

The LM path's five kernels (``flash_attention``, ``decode_attention``,
``embedding_lookup``, ``embedding_scatter_add``, ``dequantize_rows``)
are also ``torch.library`` custom ops (namespace ``repro_torch``), each
with a fake implementation (output shape, dtype and strides only), a
FLOP formula in ``torch.utils.flop_counter``'s registry and a byte count
in ``OP_BYTES``, so that the dry-run can count a step on fake tensors
and ``DTensor``s. A wrapper takes its direct route when ``direct``
says so (plain tensors, no dispatch mode), and the op otherwise; a
``DTensor`` argument goes through the kernel's sharding rule
(``local_map``) to the op on the local shards.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("hashmap_probe", "embedding_lookup", "ftrl_row_update",
           "delta_codec", "flash_attention", "flash_attention_sm90",
           "decode_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# flags of one source only, after its file name (libraries after the
# objects that need them); part of its library's digest
EXTRA_FLAGS = {"flash_attention_sm90": ("-lcuda",)}

# the C interfaces' dtype codes (float32 and bfloat16 kernels)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# custom op -> bytes(args, kwargs, out) the kernel moves: each input read
# and each output written once, as ``launch/hlo_analysis`` counts them
OP_BYTES: dict = {}

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
    flags = " ".join(NVCC_FLAGS + EXTRA_FLAGS.get(name, ()))
    digest = hashlib.sha256(src + flags.encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every named source whose library is missing, one ``nvcc``
    process per source, all started together. Returns ``{name: compiler
    output}`` for the sources compiled (``-Xptxas -v`` prints registers,
    shared memory and spills per kernel), also kept beside each library
    (``build_log``). Raises ``RuntimeError`` naming each source that
    failed, with its compiler output."""
    jobs = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu"),
               *EXTRA_FLAGS.get(name, ())]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, so)
    logs, failed = {}, []
    for name, (proc, tmp, so) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            so.with_suffix(".log").write_text(logs[name])
            os.replace(tmp, so)         # atomic: concurrent builds agree
        else:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n"
                          f"{logs[name]}")
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return logs


def build_log(name: str) -> str:
    """The compiler output of the library built for ``csrc/<name>.cu``
    (kept beside it), or "" if it has not been built."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


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


def rows_aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` if its last axis is contiguous and every row starts on a
    16-byte boundary (the kernels' vector loads), else a contiguous copy."""
    word = 16 // t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st % word == 0 for st in t.stride()[:-1])):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def direct(*tensors: torch.Tensor) -> bool:
    """True when a wrapper may take its direct route: every tensor is a
    plain ``torch.Tensor`` (no ``DTensor``, no fake tensor) and no
    dispatch mode is active (no fake mode, no counting mode). Else the
    wrapper calls its custom op, which the modes see. One C call and a
    type check a tensor: no allocation."""
    if torch._C._len_torch_dispatch_stack():
        return False
    for t in tensors:
        if type(t) is not torch.Tensor:
            return False
    return True


def nbytes(*tensors) -> int:
    """Bytes of the tensors' elements (None counts 0)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def dense_stride(shape, like: torch.Tensor) -> tuple[int, ...]:
    """Dense strides of ``shape`` with ``like``'s dim order (its dims
    sorted by stride, innermost last): the global strides of a DTensor
    whose shards are laid out as ``like``."""
    order = sorted(range(len(shape)), key=lambda d: (like.stride(d), d),
                   reverse=True)
    out, step = [0] * len(shape), 1
    for d in reversed(order):
        out[d] = step
        step *= max(1, shape[d])
    return tuple(out)


def dtensor_args(*args) -> bool:
    """True when any argument is a ``DTensor``; a plain tensor or None is
    passed over by a type check alone."""
    for a in args:
        if a is None or type(a) is torch.Tensor:
            continue
        from torch.distributed.tensor import DTensor
        if isinstance(a, DTensor):
            return True
    return False


def local_map(fn, args, in_placements, out_placements, out_shape, mesh):
    """Run ``fn`` on the local shards of ``args`` laid out as
    ``in_placements`` (one tuple a tensor argument, None for a
    non-tensor), and wrap its output as a ``DTensor`` of ``out_shape``
    with ``out_placements`` (None: ``fn`` returns nothing; lists of
    both: ``fn`` returns that many tensors). A ``DTensor`` argument is
    redistributed where its placements differ (DTensor issues and counts
    the collectives); a plain tensor argument stands for a replicated
    one (split locally, no collective, where asked). Every
    step is differentiable, so ``fn``'s own backward runs on the local
    shards too."""
    from torch.distributed.tensor import DTensor, Replicate
    local = []
    for a, pl in zip(args, in_placements):
        if pl is None:
            local.append(a)
            continue
        if not isinstance(a, DTensor):
            if all(isinstance(p, Replicate) for p in pl):
                local.append(a)
                continue
            # a plain tensor stands for a replicated one: take its shard
            a = DTensor.from_local(a, mesh, (Replicate(),) * mesh.ndim,
                                   run_check=False)
        if tuple(a.placements) != tuple(pl):
            a = a.redistribute(mesh, pl)
        local.append(a.to_local())
    out = fn(*local)
    if out_placements is None:
        return None
    if isinstance(out_shape, list):
        return tuple(DTensor.from_local(o, mesh, pl, run_check=False,
                                        shape=torch.Size(sh),
                                        stride=dense_stride(sh, o))
                     for o, pl, sh in zip(out, out_placements, out_shape))
    return DTensor.from_local(out, mesh, out_placements, run_check=False,
                              shape=torch.Size(out_shape),
                              stride=dense_stride(out_shape, out))


def mesh_of(*args):
    """The ``DeviceMesh`` of the first ``DTensor`` argument."""
    from torch.distributed.tensor import DTensor
    return next(a.device_mesh for a in args if isinstance(a, DTensor))


def placements_of(t, mesh) -> tuple:
    """``t``'s placements on ``mesh``, all ``Replicate`` for a plain
    tensor."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor):
        return tuple(t.placements)
    return (Replicate(),) * mesh.ndim


def shard_dim(p) -> Optional[int]:
    """The tensor dim a placement shards (plain ``Shard`` only), else
    None."""
    from torch.distributed.tensor import Shard
    return p.dim if type(p) is Shard else None


def local_extent(shape, mesh, placements) -> tuple[list, list]:
    """``(local shape, global offset)`` of this rank's shard of a
    ``shape`` tensor under plain ``Shard`` / ``Replicate`` / ``Partial``
    placements (``torch.chunk``'s split, mesh dims outer first), in
    Python arithmetic: no tensor op, so it runs under a fake mode."""
    size, offset = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        d = shard_dim(p)
        if d is None:
            continue
        n = mesh.size(i)
        chunk = -(-size[d] // n)
        start = min(coord[i] * chunk, size[d])
        offset[d] += start
        size[d] = max(0, min(chunk, size[d] - start))
    return size, offset
