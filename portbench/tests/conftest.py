"""A tiny spec of the benchmark in a temporary directory: one dense config
small enough for the CPU, a serving and a training traffic mix cut from
the committed ones, and the committed per-layer readers."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {
    "name": "tiny", "source": "test",
    "published": {"num_hidden_layers": 2, "hidden_size": 64,
                  "num_attention_heads": 4, "num_key_value_heads": 2,
                  "intermediate_size": 96, "vocab_size": 500,
                  "rope_theta": 10000.0, "rms_norm_eps": 1e-06,
                  "tie_word_embeddings": True},
    "assumed": {}, "reduced": [], "reference": "dense_decoder",
    "port": {"arch": "qwen2-0.5b",
             "fields": {"qkv_bias": True, "sliding_window": 0,
                        "param_dtype": "float32",
                        "activation_dtype": "float32"}},
}


def tiny_traffic() -> dict:
    serve = json.loads((ROOT / "portbench/traffic/qwen2_long_doc.json")
                       .read_text())
    serve.pop("sweep", None)
    hp, lp = serve["classes"]
    hp["prompt_lens"], lp["prompt_lens"] = [16, 32, 48, 64], [8, 16, 24]
    # deadlines and a rate at which every request is done on a busy CPU:
    # a judged request that is not done makes a run not correct
    hp["deadline_s"] = {"16": 2.0, "32": 3.0, "48": 4.0, "64": 6.0}
    lp["deadline_s"] = {"8": 3.0, "16": 4.0, "24": 5.0}
    serve["arrivals"]["rate_per_s"] = 5.0
    serve.update(requests_per_episode=24,
                 check={"episodes": 1, "hp_requests": 4, "logit_gap": 1e-4,
                        "kv_rel_err": 1e-4})
    train = json.loads((ROOT / "portbench/traffic/qwen2_train_4k.json")
                       .read_text())
    train.update(batch=2, seq_len=32)
    return {"tiny_serve": serve, "tiny_train": train}


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    """A checkout-like directory holding the tiny spec and its files."""
    bench = tmp_path / "portbench"
    for sub in ("configs", "traffic"):
        (bench / sub).mkdir(parents=True)
    shutil.copytree(ROOT / "portbench/metrics", bench / "metrics")
    (bench / "configs/tiny.json").write_text(json.dumps(TINY))
    for name, t in tiny_traffic().items():
        (bench / f"traffic/{name}.json").write_text(json.dumps(t))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"] = [{"name": "tiny", "source": "test", "reduced": [],
                        "file": "portbench/configs/tiny.json", "why": "t"}]
    spec["workloads"] = [
        {"name": "tiny.serve", "config": "tiny", "traffic": "tiny_serve",
         "chips": 1, "why": "t"},
        {"name": "tiny.train", "config": "tiny", "traffic": "tiny_train",
         "chips": 1, "why": "t"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            train = any(w.endswith("train_4k") for w in m["workloads"])
            m["workloads"] = ["tiny.train"] if train else ["tiny.serve"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path


def run_cell(root: Path, name: str, trace: bool = False,
             fault: str | None = None, seconds: float = 0.5) -> dict:
    """One run of a tiny cell on the CPU (the look for a card skipped)."""
    import time
    from portbench import bench, serve, train
    cell = bench.load_cell(name, root / "BENCHMARK.json", root)
    driver = serve if cell.traffic["kind"] == "serve" else train
    read = bench.read_per_layer
    bench.read_per_layer = lambda c, ctx: read(c, ctx, root)
    try:
        return driver.run(cell, 2**31 + 77, seconds, trace,
                          time.perf_counter(), device="cpu", fault=fault)
    finally:
        bench.read_per_layer = read
