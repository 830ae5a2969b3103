"""The PyTorch port stands alone: importing ``msrflute_tpu_torch`` and every
one of its submodules pulls neither JAX (nor flax/optax) nor anything of
``msrflute_tpu`` into ``sys.modules``, and no source file of the port or
``chip_smoke.py`` imports them."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msrflute_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_sources():
    root = os.path.join(REPO, "msrflute_tpu_torch")
    for base, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(base, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import msrflute_tpu_torch\n"
        "for m in pkgutil.walk_packages(msrflute_tpu_torch.__path__,\n"
        "                               'msrflute_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if any(\n"
        f"    n == f or n.startswith(f + '.') for f in {FORBIDDEN!r}))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]


@pytest.mark.parametrize("path", list(_port_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_source_imports_jax(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


@pytest.mark.parametrize("module", [
    "msrflute_tpu_torch.models.nlp", "msrflute_tpu_torch.privacy",
    "msrflute_tpu_torch.ops.quantization", "msrflute_tpu_torch.ops.quant_bin",
    "msrflute_tpu_torch.ops.gaussian_noise", "msrflute_tpu_torch.strategies.dga",
])
def test_slice_two_modules_import_without_building(module):
    """The DGA slice's modules import (no kernel is built at import: the
    CUDA sources compile at first use, on a machine with ``nvcc``)."""
    import importlib
    mod = importlib.import_module(module)
    assert mod.__name__ == module


@pytest.mark.parametrize("module", [
    "msrflute_tpu_torch.ops.flash_attention",
    "msrflute_tpu_torch.models.ringlm",
])
def test_slice_three_modules_import_without_building(module):
    """The RingLM slice's modules import without building kernels B4-B6."""
    import importlib
    mod = importlib.import_module(module)
    assert mod.__name__ == module
    from msrflute_tpu_torch.ops import _build
    assert "flash_attention" not in _build._loaded


@pytest.mark.parametrize("module", [
    "msrflute_tpu_torch.models.resnet",
    "msrflute_tpu_torch.models.nlp",
    "msrflute_tpu_torch.models.cv",
    "msrflute_tpu_torch.engine.checkpoint",
])
def test_slice_six_modules_import_without_building(module):
    """The ResNet, LSTM, CIFAR_CNN and checkpoint modules import without
    building kernel B1."""
    import importlib
    mod = importlib.import_module(module)
    assert mod.__name__ == module
    from msrflute_tpu_torch.ops import _build
    assert "fused_sgd" not in _build._loaded


@pytest.mark.parametrize("module", [
    "msrflute_tpu_torch.models.registry",
    "msrflute_tpu_torch.plugins",
    "msrflute_tpu_torch.plugins.hello_mlp",
    "msrflute_tpu_torch.engine.personalization",
    "msrflute_tpu_torch.engine.evaluation",
    "msrflute_tpu_torch.strategies.fedlabels",
    "msrflute_tpu_torch.data.augment",
])
def test_slice_seven_modules_import_without_building(module):
    """The plugin loader and its hello_mlp twin, the personalization
    server and FedLabels with RandAugment import without building kernel
    B1 (and so does the plugin twin's package: ``task.py`` of a plugin
    folder is never imported)."""
    import importlib
    mod = importlib.import_module(module)
    assert mod.__name__ == module
    from msrflute_tpu_torch.ops import _build
    assert "fused_sgd" not in _build._loaded


def test_every_cuda_source_has_its_notes():
    """Each kernel source says which TPU kernel it replaces (or what it
    checks) and what bounds it on the card."""
    csrc = os.path.join(REPO, "msrflute_tpu_torch", "csrc")
    sources = sorted(f for f in os.listdir(csrc) if f.endswith(".cu"))
    assert {"fused_sgd.cu", "gaussian_noise.cu", "quant_bin.cu",
            "flash_attention.cu"} <= set(sources)
    for f in sources:
        with open(os.path.join(csrc, f)) as fh:
            text = fh.read()
        assert "Bound" in text, f
        if f != "philox_check.cu":
            assert "Replaces the TPU kernel" in text, f
            assert "pallas_call" in text and (
                "pallas_kernels.py:" in text or
                "pallas_attention.py:" in text), f
