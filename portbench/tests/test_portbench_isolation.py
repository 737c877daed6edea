"""Nothing the benchmark runs imports the JAX stack or the JAX package
(``jax``, ``jaxlib``, ``flax``, ``repro``), and its plain references
import nothing of the program (``repro_torch``) either. Module names are
compared by their top-level part whole: ``repro_torch`` is not
``repro``.

The walk follows every import of every file the card runs from
``portbench/`` (at module level or inside a function) into
``portbench/`` and the port's own sources, transitively. A tiny run in a
fresh process then checks what it really loaded."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

BENCH = harness.BENCH
SRC = harness.ROOT / "src"
FORBIDDEN = set(harness.FORBIDDEN_MODULES)


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            names.add(node.module)
            names.update(f"{node.module}.{a.name}" for a in node.names)
    return names


def _file_of(module: str):
    parts = module.split(".")
    base = {"portbench": harness.ROOT, "repro_torch": SRC}.get(parts[0])
    if base is None:
        return None
    p = base.joinpath(*parts)
    for cand in (p.with_suffix(".py"), p / "__init__.py"):
        if cand.exists():
            return cand
    return None


def closure(start: Path) -> tuple[set, set]:
    """``(files reached, top-level module names imported)`` from
    ``start``, following imports into ``portbench`` and ``repro_torch``."""
    seen, tops, todo = set(), set(), [start]
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        for name in _imports(f):
            tops.add(name.split(".", 1)[0])
            g = _file_of(name)
            if g is not None:
                todo.append(g)
    return seen, tops


def _chip_files():
    return sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", _chip_files(),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_reached(path):
    files, tops = closure(path)
    assert not tops & FORBIDDEN, (path, sorted(tops & FORBIDDEN))


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    files, tops = closure(path)
    assert "repro_torch" not in tops and not tops & FORBIDDEN, sorted(tops)
    assert all(BENCH in f.parents for f in files)


def test_the_walk_sees_the_port():
    """The walk from ``run.py`` reaches the port's modules (so it would
    see an import of the JAX package there)."""
    files, tops = closure(BENCH / "kinds" / "train.py")
    assert "repro_torch" in tops
    assert any(SRC in f.parents for f in files)


def test_a_run_loads_no_jax():
    """A tiny cell end to end in a fresh process, then the loaded
    modules by top-level name."""
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from portbench.tests import tiny\n"
            "from portbench import harness\n"
            "out = tiny.run('qwen2-1.5b.train', seconds=0.2)\n"
            "assert out['correct'], out\n"
            "print(harness.forbidden_modules())\n"
            % (str(SRC), str(harness.ROOT)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"
