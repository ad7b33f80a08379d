"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the port: each module's top-level name
(the part before the first dot) is compared whole, since the port's name
begins with the JAX package's."""

import ast
import subprocess
import sys
from pathlib import Path

from cudabench.tests.tiny import ROOT

BENCH = ROOT / "cudabench"
FORBIDDEN = {"jax", "jaxlib", "flax", "advchain_tpu"}


def _tops(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(where):
    return [p for p in where.rglob("*.py") if "tests" not in p.parts]


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources(BENCH):
        assert not set(_tops(path)) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_port():
    for path in _sources(BENCH / "reference"):
        assert "advchain_tpu_torch" not in set(_tops(path)), path


def test_a_run_loads_no_jax_module():
    """A tiny CPU run of each kind of step, in a fresh process, then the
    loaded modules by whole top-level name."""
    code = (
        "import sys, time\n"
        "from cudabench import harness\n"
        "from cudabench.tests.tiny import TinyManifest\n"
        "m = TinyManifest()\n"
        "for cell in ('unet16_cardiac2d.sup_b128', "
        "'pseudo3d_cardiac3d.adv_b2'):\n"
        "    harness.run_cell(m, cell, 5, 0.1, False, 'cpu', time.time(),"
        " log=lambda s: None)\n"
        "import cudabench.control, cudabench.run\n"
        "print(sorted({k.split('.')[0] for k in sys.modules} & "
        f"set({sorted(FORBIDDEN)!r})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card(tmp_path):
    """No CUDA device: a non-zero exit and no result line."""
    out = subprocess.run(
        [sys.executable, "cudabench/run.py", "--workload",
         "unet16_cardiac2d.sup_b128", "--seed", str(2 ** 33 + 1),
         "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
