"""The PyTorch port stands alone: importing ``msrflute_tpu_torch`` and every
one of its submodules pulls neither JAX (nor flax/optax/transformers) nor
anything of ``msrflute_tpu`` into ``sys.modules``, and no source file of
the port or ``chip_smoke.py`` imports them."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "transformers",
             "msrflute_tpu")


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


#: each slice's modules and the kernel library that importing them must
#: not build (the CUDA sources compile at first use, on a machine with
#: ``nvcc``): the DGA slice's, RingLM's (B4-B6), slice 6's ResNet, LSTM,
#: CIFAR_CNN and checkpoint, slice 7's plugin loader, personalization
#: server and FedLabels with RandAugment, slice 8's ECG_CNN, NRMS, the
#: BERT masked LM (written in the repo, no ``transformers``), the
#: deterministic lookup, the attack metrics and the client Adam tail, and
#: the optimizer family, schedules, layer controls, precision policy and
#: server replay (B1's and B4-B6's 16-bit arms), and the later strategies,
#: DGA's RL hook and the hdf5 reader (B3 on EF quantization's path; the
#: reader imports ``h5py`` only when it reads), and the defense slice's
#: chaos schedule, shield, robust aggregators, secure aggregation, FedAvg's
#: local DP and the RDP accountant, and the carry slice's personalization
#: strategy and fused RL (B1 and B3 on their paths), and the resilience
#: slice's retry and escalation, preemption handler and the package that
#: gathers them (B1 on their paths)
SLICE_MODULES = [(m, None) for m in (
    "msrflute_tpu_torch.models.nlp", "msrflute_tpu_torch.privacy",
    "msrflute_tpu_torch.ops.quantization", "msrflute_tpu_torch.ops.quant_bin",
    "msrflute_tpu_torch.ops.gaussian_noise",
    "msrflute_tpu_torch.strategies.dga")] + [
    (m, "flash_attention") for m in (
        "msrflute_tpu_torch.ops.flash_attention",
        "msrflute_tpu_torch.models.ringlm")] + [
    (m, "fused_sgd") for m in (
        "msrflute_tpu_torch.models.resnet", "msrflute_tpu_torch.models.nlp",
        "msrflute_tpu_torch.models.cv", "msrflute_tpu_torch.engine.checkpoint",
        "msrflute_tpu_torch.models.registry", "msrflute_tpu_torch.plugins",
        "msrflute_tpu_torch.plugins.hello_mlp",
        "msrflute_tpu_torch.engine.personalization",
        "msrflute_tpu_torch.engine.evaluation",
        "msrflute_tpu_torch.strategies.fedlabels",
        "msrflute_tpu_torch.data.augment")] + [
    (m, "quant_bin") for m in (
        "msrflute_tpu_torch.models.ecg", "msrflute_tpu_torch.models.fednewsrec",
        "msrflute_tpu_torch.models.bert", "msrflute_tpu_torch.models.embed",
        "msrflute_tpu_torch.privacy.attacks", "msrflute_tpu_torch.optim.fused")] + [
    (m, "fused_sgd") for m in (
        "msrflute_tpu_torch.optim.factory",
        "msrflute_tpu_torch.optim.schedulers",
        "msrflute_tpu_torch.engine.client_update",
        "msrflute_tpu_torch.engine.round", "msrflute_tpu_torch.engine.server",
        "msrflute_tpu_torch.tasks", "msrflute_tpu_torch.models.convert")] + [
    (m, "quant_bin") for m in (
        "msrflute_tpu_torch.rl", "msrflute_tpu_torch.rl.rl",
        "msrflute_tpu_torch.strategies.qffl",
        "msrflute_tpu_torch.strategies.fedac",
        "msrflute_tpu_torch.strategies.fedbuff",
        "msrflute_tpu_torch.strategies.scaffold",
        "msrflute_tpu_torch.strategies.ef_quant",
        "msrflute_tpu_torch.data.user_blob")] + [
    (m, "fused_sgd") for m in (
        "msrflute_tpu_torch.resilience.chaos", "msrflute_tpu_torch.robust",
        "msrflute_tpu_torch.robust.shield",
        "msrflute_tpu_torch.privacy.accountant",
        "msrflute_tpu_torch.strategies.robust",
        "msrflute_tpu_torch.strategies.secure_agg",
        "msrflute_tpu_torch.strategies.fedavg")] + [
    (m, "quant_bin") for m in (
        "msrflute_tpu_torch.strategies.personalized",
        "msrflute_tpu_torch.rl.fused")] + [
    (m, "fused_sgd") for m in (
        "msrflute_tpu_torch.resilience",
        "msrflute_tpu_torch.resilience.integrity",
        "msrflute_tpu_torch.resilience.preemption")]


@pytest.mark.parametrize("module,kernel", SLICE_MODULES,
                         ids=[m for m, _ in SLICE_MODULES])
def test_slice_modules_import_without_building(module, kernel):
    import importlib
    mod = importlib.import_module(module)
    assert mod.__name__ == module
    if kernel is not None:
        from msrflute_tpu_torch.ops import _build
        assert kernel not in _build._loaded


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
