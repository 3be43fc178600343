"""Nothing the benchmark runs imports JAX, the JAX package, the repo's
``chip_smoke.py`` or ``tools/``; the reference imports nothing of the
program either. Names are compared whole: ``selkies_tpu_torch`` begins
with ``selkies_tpu``."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "selkies_tpu", "chip_smoke", "tools"}


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_forbidden_import(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "selkies_tpu_torch" not in set(top_level_imports(path))


def test_loaded_modules_in_a_fresh_process():
    code = ("import sys; sys.path.insert(0, %r); "
            "import streambench.harness, streambench.control; "
            "import streambench.reference.jpeg as r; "
            "import selkies_tpu_torch.server.data_server; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(BENCH.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    loaded = set(eval(out))
    assert not loaded & FORBIDDEN


def test_the_reference_alone_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import streambench.reference.jpeg; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(BENCH.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert not set(eval(out)) & (FORBIDDEN | {"selkies_tpu_torch"})
