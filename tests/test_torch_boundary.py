"""Boundary of the PyTorch port (``repro_torch``): its copies of the
jax-free modules stay verbatim, it imports neither JAX nor the JAX package,
and its entry points refuse to run on a missing card instead of falling
back to the CPU."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import model as M
from repro_torch.serving.cost_model import CostModel, PhaseCost, \
    measure_cost_model
from repro_torch.serving.engine import PreemptiveServingEngine
from repro_torch.training.steps import make_prefill_step, make_serve_step

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "repro_torch"
COPIES = [f"core/{n}.py" for n in (
    "__init__", "task", "calendar", "metrics", "network", "profiles",
    "policy", "scheduler", "victims", "workstealer", "oracle")] + [
    "sim/events.py", "models/config.py", "configs/qwen2_0_5b.py",
    "configs/smollm_135m.py"]
PORT_FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro"}


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_is_verbatim(rel):
    assert (PORT / rel).read_bytes() == \
        (REPO / "src" / "repro" / rel).read_bytes()


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_jax_or_repro_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path.relative_to(REPO)}:{node.lineno} imports {name}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_kernel_sources_are_found():
    assert _build.all_kernels() == ["decode_attention", "flash_attention"]
    for name in _build.all_kernels():
        lib = _build.library_path(name)
        assert lib.parent == _build.BUILD_DIR
        assert lib == _build.library_path(name)     # stable content hash


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _cost():
    cost = CostModel()
    cost.prefill[1] = PhaseCost(0.05, 0.005)
    cost.decode[2] = PhaseCost(0.02, 0.002)
    return cost


def test_engine_without_device_raises_without_a_card(no_card):
    cfg = get_smoke_config("qwen2-0.5b")
    params = M.init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PreemptiveServingEngine(cfg, params, _cost())
    # asking for the CPU explicitly is the only way onto it
    PreemptiveServingEngine(cfg, params, _cost(), device="cpu")


@pytest.mark.parametrize("entry", [
    lambda cfg: M.init_params(cfg, 0),
    lambda cfg: make_prefill_step(cfg, 16),
    lambda cfg: make_serve_step(cfg),
    lambda cfg: measure_cost_model(cfg, reps=1),
], ids=["init_params", "make_prefill_step", "make_serve_step",
        "measure_cost_model"])
def test_entry_points_default_to_cuda(no_card, entry):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry(get_smoke_config("qwen2-0.5b"))


def test_engine_refuses_params_on_another_device():
    cfg = get_smoke_config("qwen2-0.5b")
    params = M.init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="params live on"):
        PreemptiveServingEngine(cfg, params, _cost(), device="meta")


def test_kernel_wrappers_do_not_fall_back_off_the_cpu():
    """Only CPU tensors take the plain version: any other device launches
    the kernel or raises (here: meta tensors, which no kernel takes)."""
    q = torch.empty((1, 4, 8), device="meta")
    kv = torch.empty((1, 16, 2, 8), device="meta")
    pos = torch.empty((1, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="needs CUDA"):
        decode_attention(q, kv, kv, pos, 3)
    q4 = torch.empty((1, 5, 4, 8), device="meta")
    k4 = torch.empty((1, 5, 2, 8), device="meta")
    p = torch.empty((5,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="needs CUDA"):
        flash_attention(q4, k4, k4, p, p)
    assert decode_attention.launches == 0 and flash_attention.launches == 0
