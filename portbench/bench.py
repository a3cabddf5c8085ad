"""What every cell shares: the spec and the files found by name, the card's
peaks, the build and kernel caches, and the result line.

Nothing here imports the port or JAX; the drivers (``serve.py``,
``train.py``) import the port once the harness has checked for a card.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]      # the checkout
SPEC_PATH = ROOT / "BENCHMARK.json"

# H100 SXM, NVIDIA data sheet, dense rates at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
PEAK_F32 = 67e12          # f32 outside the tensor cores (TF32 off)
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12        # bf16 / fp16 tensor cores

# Top-level module names that may not be loaded in a run's process.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")

# A published config.json key -> the port's ModelConfig field.
HF_TO_PORT = {
    "num_hidden_layers": "n_layers",
    "hidden_size": "d_model",
    "num_attention_heads": "n_heads",
    "num_key_value_heads": "n_kv_heads",
    "intermediate_size": "d_ff",
    "vocab_size": "vocab_size",
    "rope_theta": "rope_theta",
    "rms_norm_eps": "norm_eps",
    "tie_word_embeddings": "tie_embeddings",
    "sliding_window": "sliding_window",
}


def cache_env() -> None:
    """Fixed build and kernel cache directories inside the checkout, so that
    only a cell's first run in a checkout builds (the port's nvcc libraries
    go to ``build/kernels`` there by themselves)."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload of the spec with the files its names lead to."""

    name: str
    spec: dict
    workload: dict
    config: dict          # the configuration file's content
    traffic: dict         # the traffic file's content
    end_to_end: list
    per_layer: list


def metric_applies(metric: dict, workload: str, spec: dict) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    if metric.get("moves"):                 # per-layer: follows its moves
        moved = next(m for m in spec["end_to_end"]
                     if m["name"] == metric["moves"])
        return metric_applies(moved, workload, spec)
    return True


def load_cell(name: str, spec_path: Path = SPEC_PATH,
              root: Path = ROOT) -> Cell:
    spec = load_json(spec_path)
    try:
        wl = next(w for w in spec["workloads"] if w["name"] == name)
    except StopIteration:
        raise SystemExit(f"unknown workload {name!r}") from None
    conf = next(c for c in spec["configs"] if c["name"] == wl["config"])
    config = load_json(root / conf["file"])
    traffic = load_json(root / "portbench" / "traffic"
                        / f"{wl['traffic']}.json")
    e2e = [m for m in spec["end_to_end"] if metric_applies(m, name, spec)]
    per_layer = [m for m in spec["per_layer"]
                 if metric_applies(m, name, spec)]
    return Cell(name, spec, wl, config, traffic, e2e, per_layer)


def reader(metric: str, root: Path = ROOT):
    """The reader of a per-layer metric: ``portbench/metrics/<name>.py``'s
    ``read(ctx)``, loaded by path (a name may hold dots)."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_per_layer(cell: Cell, ctx: dict, root: Path = ROOT) -> dict:
    """Each per-layer metric its reader finds something for; a reader that
    finds nothing returns None and the metric is left out."""
    out = {}
    for m in cell.per_layer:
        value = reader(m["name"], root)(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def values(config: dict) -> dict:
    """The numbers a configuration runs: its published ones, and the ones
    it sets itself under ``assumed``."""
    return {**config.get("assumed", {}), **config["published"]}


def reference_model(config: dict):
    """The plain reference of a configuration's family:
    ``portbench/reference/<config["reference"]>.py``."""
    return importlib.import_module(
        f"portbench.reference.{config['reference']}")


def port_config(config: dict):
    """The port's ModelConfig with every number of the configuration file:
    the registry entry named under ``port.arch`` gives the architecture's
    structure, and ``dataclasses.replace`` sets the file's values."""
    from repro_torch.configs import get_config
    port = config["port"]
    fields = {HF_TO_PORT[k]: v for k, v in values(config).items()
              if k in HF_TO_PORT}
    # the published table: no rows padded beyond ``vocab_size``
    fields = {"vocab_pad_multiple": 1, **fields,
              **port.get("fields", {})}
    return dataclasses.replace(get_config(port["arch"]), stages=(),
                               **fields)


def matmul_peak(dtype_name: str, tf32: bool) -> float:
    """Peak of a cuBLAS product of this input dtype under the TF32 setting."""
    if dtype_name == "float32":
        return PEAK_TF32 if tf32 else PEAK_F32
    if dtype_name in ("bfloat16", "float16"):
        return PEAK_BF16
    raise ValueError(f"no peak for {dtype_name}")


def kernel_peak(dtype_name: str) -> float:
    """Peak of the port's attention kernels, whose products run on the bf16
    tensor cores in any input dtype (f32 as split bf16 passes): the bf16
    peak bounds them, so a share of it cannot pass 100 %."""
    return PEAK_BF16


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN_MODULES))


def device_info(torch, count: int, peak: int, trace: dict | None) -> dict:
    d = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
         "count": count, "memory_peak_bytes": int(peak)}
    if trace is not None:
        d["busy_s"] = trace["busy_s"]
        d["window_s"] = trace["window_s"]
    return d


def emit(result: dict, checks: dict) -> None:
    """Print the compared numbers beside their limits as the last lines of
    standard error, and the result, with ``checks`` as its last key, as the
    last line of standard output."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    result = dict(result)
    result["checks"] = checks
    print(json.dumps(result), flush=True)
