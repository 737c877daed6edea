#!/usr/bin/env python3
"""Time the row gather and row scatter-set kernels of this tree against
those built from another version of ``csrc/embedding_lookup.cu``, on one
CUDA card, in turns (other, this, this, other), at the shapes
``chip_smoke.py`` times them: 131,072 ids into a 2^21 x D float32 table
for D = 1, 8 and 9, and qwen2-1.5b's token gather (8,192 ids x 1,536
bf16 from its 152,064-row table). Each pair of outputs must be
bit-equal, or the script fails.

    git show <rev>:src/repro_torch/kernels/csrc/embedding_lookup.cu \\
        > build/other_embedding_lookup.cu
    python3 scripts/compare_copy_kernels.py build/other_embedding_lookup.cu

The other source's copy entries must take ``(table, row_bytes, ids, n,
rows, stream)``: the C interface before ``copy_plan``. It is built with
the port's ``nvcc`` flags into ``build/repro_torch/compare/``. Prints the
card's name and power limit, a line a shape and kernel, and a JSON object
of every time last. Device times come from ``chip_smoke._device_ms`` (a
CUDA graph of 20 calls, replayed).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def build_other(src: Path) -> ctypes.CDLL:
    """The library built from ``src`` with the port's flags, its copy
    entries bound with the older interface."""
    from repro_torch.kernels import _build
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    so = _build.BUILD_DIR / "compare" / f"libother-{digest}.so"
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        r = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                            str(src)], capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(so))
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    for fn in (lib.embedding_lookup, lib.embedding_scatter):
        fn.argtypes = [p, ll, p, ll, p, p]
        fn.restype = ctypes.c_int
    return lib


def _call(cfunc, table, ids, rows) -> None:
    import torch
    rc = cfunc(table.data_ptr(), table.shape[1] * table.element_size(),
               ids.data_ptr(), ids.shape[0], rows.data_ptr(),
               torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"other library: CUDA error {rc}")


def shapes(dev):
    """(label, table, gather ids, unique scatter ids, updates), as
    ``chip_smoke.phase_kernels`` makes them."""
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    n = cs.REQ_BATCH * cs.FIELDS
    for d in (1, 8, 9):
        yield (f"{cs.COPY_ROWS}x{d} f32, {n} ids",
               torch.randn(cs.COPY_ROWS, d, device=dev),
               torch.randint(0, cs.COPY_ROWS, (n,), device=dev,
                             dtype=torch.int32),
               torch.randperm(cs.COPY_ROWS, device=dev)[:n].to(torch.int32),
               torch.randn(n, d, device=dev))
    cfg = get_config(cs.LM_ARCH)
    n = cs.PREFILL_BATCH * cs.PREFILL_LEN
    yield (f"{cfg.padded_vocab}x{cfg.d_model} bf16, {n} ids",
           torch.randn(cfg.padded_vocab, cfg.d_model, device=dev,
                       dtype=torch.bfloat16),
           torch.randint(0, cfg.vocab_size, (n,), device=dev,
                         dtype=torch.int32),
           torch.randperm(cfg.vocab_size, device=dev)[:n].to(torch.int32),
           torch.randn(n, cfg.d_model, device=dev, dtype=torch.bfloat16))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path,
                    help="the other version of csrc/embedding_lookup.cu")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("compare_copy_kernels: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import embedding_lookup as el
    torch.manual_seed(cs.SEED)
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    other = build_other(args.other)
    results = []
    for label, table, ids, uniq, upd in shapes(dev):
        out = torch.empty(ids.shape[0], table.shape[1], dtype=table.dtype,
                          device=dev)
        fns = {"embedding_lookup": (
            lambda: _call(other.embedding_lookup, table, ids, out),
            lambda: el.embedding_lookup(table, ids)),
            "embedding_scatter": (
            lambda: _call(other.embedding_scatter, table, uniq, upd),
            lambda: el.embedding_scatter(table, uniq, upd))}
        _call(other.embedding_lookup, table, ids, out)
        if not torch.equal(out, el.embedding_lookup(table, ids)):
            raise AssertionError(f"gather at {label}: not bit-equal")
        mine = el.embedding_scatter(table.clone(), uniq, upd)
        theirs = table.clone()
        _call(other.embedding_scatter, theirs, uniq, upd)
        if not torch.equal(mine, theirs):
            raise AssertionError(f"scatter-set at {label}: not bit-equal")
        del mine, theirs
        for name, (old, new) in fns.items():
            t = [cs._device_ms(f) for f in (old, new, new, old)]
            row = {"name": name, "shape": label,
                   "other_ms": (t[0] + t[3]) / 2, "this_ms": (t[1] + t[2]) / 2,
                   "turns_ms": t}
            row["ratio"] = row["this_ms"] / row["other_ms"]
            results.append(row)
            print(f"{name} at {label}: other {row['other_ms']:.5f} ms, this "
                  f"{row['this_ms']:.5f} ms ({row['ratio']:.3f}x); turns "
                  + ", ".join(f"{x:.5f}" for x in t), flush=True)
    print(json.dumps({"card": smi, "rows": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
