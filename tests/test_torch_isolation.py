"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points never drop to the CPU unasked."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a process)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "advchain_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "advchain_tpu")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'advchain_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import advchain_tpu_torch.augmentor, advchain_tpu_torch.models\n"
        "import advchain_tpu_torch.models.blocks\n"
        "import advchain_tpu_torch.kernels, advchain_tpu_torch.ops\n"
        "import advchain_tpu_torch.losses, advchain_tpu_torch.parallel\n"
        "import advchain_tpu_torch.utils\n"
        "import chip_smoke\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_point_without_device_raises_on_a_cpu_box():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from advchain_tpu_torch.models import SegmentationModel, UNet
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SegmentationModel.create(UNet(1, 4, 4))


def test_chip_smoke_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
