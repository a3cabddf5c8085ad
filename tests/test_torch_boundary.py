"""Boundary of the PyTorch port (``repro_torch``): its copies of the
jax-free modules stay verbatim, it imports neither JAX nor the JAX package,
its entry points refuse to run on a missing card instead of falling
back to the CPU, and no kernel wrapper returns a result that silently
drops the gradient."""
import ast
import contextlib
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import cached_decode_attention, \
    decode_attention
from repro_torch.kernels.flash_attention import flash_attention, \
    mha_attention
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.halo_conv2d import halo_conv_block_tiles
from repro_torch.kernels.slstm_scan import slstm_hidden_states, slstm_scan
from repro_torch.kernels.slstm_scan import ops as slstm_ops
from repro_torch.models import model as M
from repro_torch.serving.cost_model import CostModel, PhaseCost, \
    measure_cost_model
from repro_torch.serving.engine import PreemptiveServingEngine
from repro_torch.training.steps import init_train_state, \
    make_prefill_step, make_serve_step, make_train_step

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "repro_torch"
COPIES = [f"core/{n}.py" for n in (
    "__init__", "task", "calendar", "metrics", "network", "profiles",
    "policy", "scheduler", "victims", "workstealer", "oracle")] + [
    "sim/events.py", "models/config.py", "configs/qwen2_0_5b.py",
    "configs/smollm_135m.py", "configs/xlstm_1_3b.py",
    "configs/deepseek_7b.py", "configs/phi3_mini_3_8b.py",
    "configs/llava_next_34b.py", "configs/seamless_m4t_medium.py",
    "configs/deepseek_v2_236b.py", "configs/deepseek_v3_671b.py",
    "configs/jamba_1_5_large_398b.py", "configs/shapes.py",
    "core/telemetry.py", "core/calendar_reference.py", "sim/traces.py",
    "sim/experiment.py", "sim/openended.py", "serving/__init__.py",
    "sim/churn.py", "sim/chaos.py", "sim/scenarios.py",
    "sim/degrade_storm.py", "sim/__init__.py"]
PORT_FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro"}


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_is_verbatim(rel):
    assert (PORT / rel).read_bytes() == \
        (REPO / "src" / "repro" / rel).read_bytes()


def test_stream_differs_from_jax_only_in_the_priority_message():
    """``serving/stream.py`` is the JAX file with one string changed:
    ``validate_submission`` names the port's ``Priority``."""
    jax_src = (REPO / "src" / "repro" / "serving" / "stream.py").read_text()
    port_src = (PORT / "serving" / "stream.py").read_text()
    old = "must be a repro.core.task.Priority"
    assert jax_src.count(old) == 1
    assert port_src == jax_src.replace(
        old, "must be a repro_torch.core.task.Priority")


LINT_RULE_COPIES = ["determinism.py", "mirror_sync.py", "terminal_state.py"]


@pytest.mark.parametrize("name", LINT_RULE_COPIES)
def test_lint_rules_differ_from_jax_only_in_their_paths(name):
    """The port's lint rules are the JAX files with each path literal
    ``"repro/`` retargeted at ``"repro_torch/``."""
    jax_src = (REPO / "src" / "repro" / "analysis" / "rules" /
               name).read_text()
    port_src = (PORT / "analysis" / "rules" / name).read_text()
    assert '"repro/' in jax_src
    assert port_src == jax_src.replace('"repro/', '"repro_torch/')


def _without_function(src: str, name: str) -> str:
    """``src`` with the top-level function ``name`` cut out."""
    node = next(n for n in ast.parse(src).body
                if isinstance(n, ast.FunctionDef) and n.name == name)
    lines = src.splitlines(keepends=True)
    return "".join(lines[:node.lineno - 1] + lines[node.end_lineno:])


def test_lint_engine_differs_from_jax_only_in_default_rules():
    """The port's lint engine is the JAX file but for ``default_rules``:
    the same catalog without ``pallas-index``, with
    ``torch-free-boundary`` in the place of ``jax-free-boundary``."""
    jax_src = (REPO / "src" / "repro" / "analysis" / "engine.py").read_text()
    port_src = (PORT / "analysis" / "engine.py").read_text()
    assert port_src != jax_src
    assert _without_function(port_src, "default_rules") == \
        _without_function(jax_src, "default_rules")
    from repro_torch.analysis import default_rules
    assert [r.name for r in default_rules()] == [
        "mirror-sync", "dirty-notify", "terminal-state",
        "determinism-wallclock", "determinism-rng", "determinism-set-iter",
        "torch-free-boundary"]


def test_engine_validates_with_the_stream_boundary():
    """The engine keeps no copy of ``validate_submission``: it is the
    streaming engine's, as in the JAX package."""
    from repro_torch.serving import engine, stream
    assert engine.validate_submission is stream.validate_submission
    with pytest.raises(ValueError, match=r"must be a "
                       r"repro_torch\.core\.task\.Priority, got 'high'"):
        stream.validate_submission(priority="high", deadline=1.0)


def test_runtime_planes_import_no_torch():
    """The scheduler core, the simulators, the streaming engine and the
    lint plane run without torch (soak, chaos and lint users do not pay
    its import)."""
    code = ("import sys\n"
            "import repro_torch.core, repro_torch.sim, "
            "repro_torch.serving.stream, repro_torch.sim.chaos, "
            "repro_torch.sim.degrade_storm, repro_torch.analysis, "
            "repro_torch.analysis.__main__\n"
            "import repro_torch.serving as s\n"
            "s.StreamingEngine, s.validate_submission\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('torch', 'jax', 'repro'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


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


KERNEL_PACKAGES = ["decode_attention", "flash_attention", "halo_conv2d",
                   "slstm_scan"]


def test_import_check_covers_every_kernel_package():
    for name in KERNEL_PACKAGES:
        for mod in ("__init__", "ops", "ref"):
            assert PORT / "kernels" / name / f"{mod}.py" in PORT_FILES


TRAINING_MODULES = ["training/__init__.py", "training/optimizer.py",
                    "training/steps.py", "checkpoint/__init__.py",
                    "checkpoint/store.py", "checkpoint/lifecycle.py",
                    "data/__init__.py", "data/pipeline.py",
                    "configs/shapes.py"]


@pytest.mark.parametrize("rel", TRAINING_MODULES)
def test_import_check_covers_the_training_modules(rel):
    assert PORT / rel in PORT_FILES


PLANE_MODULES = ["serving/stream.py", "core/telemetry.py",
                 "core/calendar_reference.py", "sim/traces.py",
                 "sim/experiment.py", "sim/openended.py", "sim/churn.py",
                 "sim/chaos.py", "sim/scenarios.py", "sim/degrade_storm.py",
                 "sim/__init__.py", "serving/__init__.py"]


@pytest.mark.parametrize("rel", PLANE_MODULES)
def test_import_check_covers_the_runtime_planes(rel):
    assert PORT / rel in PORT_FILES


def test_kernel_sources_are_found():
    assert _build.all_kernels() == KERNEL_PACKAGES
    # the flash library holds the forward and the backward
    assert [p.name for p in _build.sources("flash_attention")] == \
        ["flash_attention.cu", "flash_attention_bwd.cu"]
    assert [p.name for p in _build.sources("slstm_scan")] == \
        ["slstm_scan.cu", "slstm_scan_bwd.cu"]
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
    lambda cfg: init_train_state(cfg, 0),
    lambda cfg: make_train_step(cfg),
], ids=["init_params", "make_prefill_step", "make_serve_step",
        "measure_cost_model", "init_train_state", "make_train_step"])
def test_entry_points_default_to_cuda(no_card, entry):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry(get_smoke_config("qwen2-0.5b"))


def test_engine_refuses_params_on_another_device():
    cfg = get_smoke_config("qwen2-0.5b")
    params = M.init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="params live on"):
        PreemptiveServingEngine(cfg, params, _cost(), device="meta")


def _no_plain_versions(monkeypatch):
    """Make every kernel's plain version raise if it is called."""
    from repro_torch.kernels.decode_attention import ops as decode_ops

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran off the CPU")

    for mod, names in ((decode_ops, ("decode_attention_ref",)),
                       (flash_ops, ("flash_attention_ref",
                                    "flash_attention_bwd_ref")),
                       (slstm_ops, ("slstm_scan_ref", "slstm_scan_saving_ref",
                                    "slstm_scan_bwd_ref"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)


def test_kernel_wrappers_do_not_fall_back_off_the_cpu(monkeypatch):
    """Only CPU tensors take the plain version.  Meta tensors (the dry
    run's abstract shards) launch nothing: the wrappers with a meta branch
    return empty meta outputs of the kernel's shapes without running the
    plain version and count no launch, and so do the model-layout
    adapters over them; the halo conv, which has none, raises as any
    device but CPU and CUDA does."""
    _no_plain_versions(monkeypatch)
    q = torch.empty((1, 4, 8), device="meta")
    kv = torch.empty((1, 16, 2, 8), device="meta")
    pos = torch.empty((1, 16), dtype=torch.int32, device="meta")
    out = decode_attention(q, kv, kv, pos, 3)
    assert out.device.type == "meta" and out.shape == q.shape
    q4 = torch.empty((1, 5, 4, 8), device="meta")
    k4 = torch.empty((1, 5, 2, 8), device="meta")
    p = torch.empty((5,), dtype=torch.int32, device="meta")
    out = flash_attention(q4, k4, k4, p, p)
    assert out.device.type == "meta" and out.shape == q4.shape
    wx = torch.empty((1, 3, 4, 2, 8), device="meta")
    r = torch.empty((4, 2, 8, 8), device="meta")
    b = torch.empty((4, 2, 8), device="meta")
    hs, final = slstm_scan(wx, r, b)
    assert hs.device.type == "meta" and hs.shape == (1, 3, 2, 8)
    assert [tuple(s.shape) for s in final] == [(1, 2, 8)] * 4
    tiles = torch.empty((4, 10, 10, 3), device="meta")
    w = torch.empty((3, 3, 3, 5), device="meta")
    with pytest.raises(ValueError, match="needs CUDA"):
        halo_conv_block_tiles(tiles, [w], tile_h=8, tile_w=8)
    q1 = torch.empty((1, 1, 4, 8), device="meta")
    out = cached_decode_attention(q1, kv, kv, pos, 3, window=8)
    assert out.device.type == "meta" and out.shape == q1.shape
    qm = torch.empty((1, 5, 4, 8), device="meta")
    for causal in (True, False):
        out = mha_attention(qm, qm, qm, causal=causal)
        assert out.device.type == "meta" and out.shape == qm.shape
    hs = slstm_hidden_states(wx, r, b)
    assert hs.device.type == "meta" and hs.shape == (1, 3, 2, 8)
    assert decode_attention.launches == 0 and flash_attention.launches == 0
    assert slstm_scan.launches == 0 and halo_conv_block_tiles.launches == 0


def _meta_inputs(requires_grad: bool):
    """Inputs of each wrapper on meta tensors (off the CPU, no card)."""
    m = lambda *shape: torch.empty(shape, device="meta",  # noqa: E731
                                   requires_grad=requires_grad)
    pos = torch.empty((1, 16), dtype=torch.int32, device="meta")
    return {
        "decode_attention": lambda: decode_attention(
            m(1, 4, 8), m(1, 16, 2, 8), m(1, 16, 2, 8), pos, 3),
        "halo_conv2d": lambda: halo_conv_block_tiles(
            m(4, 10, 10, 3), [m(3, 3, 3, 5)], tile_h=8, tile_w=8),
    }


@pytest.mark.parametrize("name", ["decode_attention", "halo_conv2d"])
def test_wrappers_without_backward_refuse_inputs_that_need_grad(name):
    """A kernel without a backward raises on inputs off the CPU that
    require grad while grad mode is on, instead of returning an output
    with no ``grad_fn``; without grad it goes on: decode attention to its
    meta branch (an empty output, no launch), the halo conv to its device
    checks."""
    with pytest.raises(RuntimeError, match=f"{name}: the CUDA kernel has "
                       "no backward"):
        _meta_inputs(True)[name]()
    for requires_grad, ctx in ((True, torch.no_grad),
                               (False, contextlib.nullcontext)):
        with ctx():
            if name == "halo_conv2d":
                with pytest.raises(ValueError, match="needs CUDA"):
                    _meta_inputs(requires_grad)[name]()
            else:
                out = _meta_inputs(requires_grad)[name]()
                assert out.device.type == "meta" and out.shape == (1, 4, 8)
    assert decode_attention.launches == 0


def test_flash_attention_needing_grad_goes_through_its_backward(
        monkeypatch):
    """Flash attention has a backward kernel: inputs that require grad go
    through ``FlashAttentionFn`` on any device (on the CPU its output
    carries the Function's grad_fn); without grad they do not."""
    calls = []

    def spy(*args):
        calls.append(args)
        return "through the Function"

    q = torch.empty((1, 5, 4, 8), device="meta", requires_grad=True)
    k = torch.empty((1, 5, 2, 8), device="meta")
    p = torch.empty((5,), dtype=torch.int32, device="meta")
    monkeypatch.setattr(flash_ops.FlashAttentionFn, "apply", spy)
    assert flash_attention(q, k, k, p, p) == "through the Function"
    with torch.no_grad():                  # the meta branch, no Function
        assert flash_attention(q, k, k, p, p).device.type == "meta"
    assert len(calls) == 1
    monkeypatch.undo()
    qc = torch.randn((1, 5, 4, 8), requires_grad=True)
    kc = torch.randn((1, 5, 2, 8))
    pc = torch.arange(5, dtype=torch.int32)
    out = flash_attention(qc, kc, kc, pc, pc)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"


def test_slstm_scan_needing_grad_goes_through_its_backward(monkeypatch):
    """The sLSTM scan has a backward kernel: inputs that require grad go
    through ``SLSTMScanFn`` on any device (on the CPU its output carries
    the Function's grad_fn); without grad they do not."""
    calls = []

    def spy(*args):
        calls.append(args)
        return ("through the Function",) * 5

    wx = torch.empty((1, 3, 4, 2, 8), device="meta", requires_grad=True)
    r = torch.empty((4, 2, 8, 8), device="meta")
    b = torch.empty((4, 2, 8), device="meta")
    monkeypatch.setattr(slstm_ops.SLSTMScanFn, "apply", spy)
    hs, final = slstm_scan(wx, r, b)
    assert hs == "through the Function" and len(final) == 4
    with torch.no_grad():                  # the meta branch, no Function
        assert slstm_scan(wx, r, b)[0].device.type == "meta"
    assert len(calls) == 1
    monkeypatch.undo()
    hs, _ = slstm_scan(wx, r, b)           # the Function's meta forward
    assert type(hs.grad_fn).__name__ == "SLSTMScanFnBackward"
    assert hs.device.type == "meta"
    wxc = torch.randn((1, 3, 4, 2, 8), requires_grad=True)
    rc = torch.randn((4, 2, 8, 8)) * 8 ** -0.5
    hs, _ = slstm_scan(wxc, rc, torch.zeros((4, 2, 8)))
    assert type(hs.grad_fn).__name__ == "SLSTMScanFnBackward"


# A JAX module without a port file of the same path -> the port's file that
# stands for it.
COUNTERPART_FILES = {
    "kernels/decode_attention/kernel.py":
        "kernels/decode_attention/csrc/decode_attention.cu",
    "kernels/flash_attention/kernel.py":
        "kernels/flash_attention/csrc/flash_attention.cu",
    "kernels/halo_conv2d/kernel.py": "kernels/halo_conv2d/csrc/halo_conv2d.cu",
    "kernels/slstm_scan/kernel.py": "kernels/slstm_scan/csrc/slstm_scan.cu",
    "launch/hlo_analysis.py": "launch/cost_analysis.py",
}
# A JAX public function or class that the port's file of the same path (or
# of COUNTERPART_FILES) lacks -> its equivalents, as (port file, name).
COUNTERPART_NAMES = {
    "kernels/decode_attention/kernel.py::decode_attention":
        [("kernels/decode_attention/ops.py", "decode_attention")],
    "kernels/flash_attention/kernel.py::flash_attention":
        [("kernels/flash_attention/ops.py", "flash_attention")],
    "kernels/halo_conv2d/kernel.py::halo_conv_block_tiles":
        [("kernels/halo_conv2d/ops.py", "halo_conv_block_tiles")],
    "kernels/slstm_scan/kernel.py::slstm_scan":
        [("kernels/slstm_scan/ops.py", "slstm_scan")],
    "launch/hlo_analysis.py::collective_bytes":
        [("launch/cost_analysis.py", "collective_stats")],
    "launch/hlo_analysis.py::roofline_from_compiled":
        [("launch/cost_analysis.py", "roofline")],
    "launch/build.py::lower_combo": [("launch/build.py", "build_combo")],
    "models/sharding.py::tree_shardings":
        [("models/sharding.py", "tree_specs"),
         ("models/sharding.py", "distribute_tree")],
    "analysis/rules/kernel_rules.py::JaxImportRule":
        [("analysis/rules/kernel_rules.py", "TorchImportRule")],
}
# A JAX public function or class with no counterpart in the port -> why.
NO_COUNTERPART = {
    "models/layers/common.py::zeros":
        "a jnp.zeros helper; the port calls torch.zeros(..., device=) inline",
    "analysis/rules/kernel_rules.py::PallasIndexRule":
        "lints pl.load/pl.store index tuples; the port has no Pallas",
}


def _public_defs(path: Path) -> set[str]:
    """Top-level public functions and classes of a source file, read with
    ``ast`` (never imported)."""
    return {n.name for n in ast.parse(path.read_text()).body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and not n.name.startswith("_")}


def test_every_jax_module_and_name_has_a_counterpart():
    """Every module of ``src/repro/`` has a port file of the same path or
    one named in COUNTERPART_FILES, and every top-level public function or
    class a definition of the same name in that file or the counterparts
    named in COUNTERPART_NAMES, or is one of the names in NO_COUNTERPART;
    no entry of any of the three is stale."""
    src = REPO / "src" / "repro"
    missing, used, absent = [], set(), set()
    for path in sorted(src.rglob("*.py")):
        rel = path.relative_to(src).as_posix()
        port_rel = COUNTERPART_FILES.get(rel, rel)
        port = PORT / port_rel
        if not port.exists():
            missing.append(f"{rel}: no {port_rel}")
            continue
        if rel in COUNTERPART_FILES:
            assert not (PORT / rel).exists(), f"{rel} is ported as itself"
        have = _public_defs(port) if port.suffix == ".py" else set()
        for name in sorted(_public_defs(path)):
            key = f"{rel}::{name}"
            if name in have:
                assert key not in COUNTERPART_NAMES, f"stale entry {key}"
                assert key not in NO_COUNTERPART, f"stale entry {key}"
                continue
            if key in NO_COUNTERPART:
                absent.add(key)
                continue
            if key not in COUNTERPART_NAMES:
                missing.append(key)
                continue
            used.add(key)
            for where, other in COUNTERPART_NAMES[key]:
                assert other in _public_defs(PORT / where), \
                    f"{key}: no {other} in {where}"
    assert not missing, missing
    assert used == set(COUNTERPART_NAMES)
    assert absent == set(NO_COUNTERPART)
