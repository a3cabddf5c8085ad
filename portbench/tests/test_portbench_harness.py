"""The harness on the CPU: files found by name, the result line, the count
arithmetic, the traffic generator, and what the benchmark imports."""
from __future__ import annotations

import ast
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest
from conftest import ROOT, run_cell

from portbench import bench, gen
from portbench.trace import Trace


def test_new_config_traffic_and_metric_found_by_name(tiny_root):
    """A configuration, a traffic mix and a per-layer metric that are only
    files (and entries of the spec) take part in a run."""
    (tiny_root / "portbench/metrics/episodes_seen.serve.py").write_text(
        "def read(ctx):\n    return ctx['run'].episodes\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["per_layer"].append(
        {"name": "episodes_seen.serve", "unit": "count", "better": "higher",
         "source": "program_counter", "layer": "serving/engine.py",
         "moves": "served_tok_s", "workloads": ["tiny.serve"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = bench.load_cell("tiny.serve", tiny_root / "BENCHMARK.json",
                           tiny_root)
    assert cell.config["name"] == "tiny"
    assert cell.traffic["requests_per_episode"] == 24
    out = run_cell(tiny_root, "tiny.serve", trace=True)
    metrics = out["result"]["metrics"]
    assert metrics["episodes_seen.serve"]["value"] >= 1
    assert metrics["hp_met_share.serve"]["unit"] == "share"
    # no trace of a card on the CPU: the device readers find nothing
    assert "flash_attn_roofline.serve" not in metrics


def test_metric_follows_its_moves_without_a_workloads_key():
    spec = {"end_to_end": [{"name": "a", "workloads": ["x"]},
                           {"name": "b"}]}
    assert bench.metric_applies({"moves": "a"}, "x", spec)
    assert not bench.metric_applies({"moves": "a"}, "y", spec)
    assert bench.metric_applies({"moves": "b"}, "y", spec)


def test_result_line_shape(capsys):
    checks = {"logit_gap": {"value": 1e-6, "limit": 1e-4},
              "schedule_faults": {"value": 0, "limit": 0}}
    bench.emit({"correct": True, "attempted": 3, "failed": 0,
                "metrics": {"setup_s": {"value": 1.5, "unit": "s"}},
                "device": {"platform": "gpu", "kind": "x", "count": 1,
                           "memory_peak_bytes": 7}}, checks)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["checks"] == checks
    assert err.strip().splitlines()[-2:] == [
        "check logit_gap 1e-06 limit 0.0001",
        "check schedule_faults 0 limit 0"]


def test_run_without_a_card_prints_no_result():
    p = subprocess.run(
        [sys.executable, str(ROOT / "portbench/run.py"), "--workload",
         "qwen2-0.5b.train_4k", "--seed", str(2**31 + 5), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.parametrize("t, window, want", [
    (1, 0, 1), (4, 0, 10), (8192, 0, 8192 * 8193 // 2),
    (4, 2, 1 + 2 + 2 + 2), (5, 8, 15)])
def test_causal_pair_count(t, window, want):
    mod = _load("flash_attn_roofline.serve")
    assert mod.pairs(t, window) == want


def _load(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_"), ROOT / f"portbench/metrics/{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Run:
    def __init__(self, dims, cache_len=64):
        self.dims, self.cache_len = dims, cache_len


def _dims(**kw):
    from portbench.reference.dense_decoder import Dims
    base = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                head_dim=16, d_ff=96, vocab_size=500, rope_theta=1e4,
                norm_eps=1e-6, tied=True)
    base.update(kw)
    return Dims(**base)


@pytest.mark.parametrize("dtype, elem", [("float32", 4), ("bfloat16", 2)])
def test_flash_roofline_by_hand(dtype, elem):
    d = _dims()
    t, secs = 1024, 1e-3
    tr = Trace(window_s=1.0, kernels=[("flash_attention_kernel<f>", 0,
                                       int(secs * 1e9))],
               spans=[(f"serve.prefill:T={t}", 0, 10**9)])
    got = _load("flash_attn_roofline.serve").read(
        {"trace": tr, "run": _Run(d), "dtype": dtype})
    flops = 4 * 16 * 4 * (t * (t + 1) // 2)
    nbytes = elem * t * 16 * 2 * (4 + 2)
    want = 100 * 2 * max(flops / 989e12, nbytes / 3.35e12) / secs
    assert math.isclose(got, want, rel_tol=1e-12)


def test_bf16_run_is_read_against_the_bf16_peak():
    assert bench.matmul_peak("bfloat16", False) == 989e12
    assert bench.matmul_peak("float32", False) == 67e12
    assert bench.matmul_peak("float32", True) == 495e12
    d = _dims(vocab_size=512)
    t, secs = 512, 2e-3
    tr = Trace(window_s=1.0, kernels=[("sgemm", 10, 10 + int(secs * 1e9))],
               spans=[(f"serve.prefill:T={t}", 0, 10**9)])
    run = _Run(d)
    got = {dt: _load("prefill_mfu.serve").read(
        {"trace": tr, "run": run, "dtype": dt, "tf32": False})
        for dt in ("float32", "bfloat16")}
    layer = 64 * 16 * (2 * 4 + 2 * 2) + 3 * 64 * 96
    mm = 2 * t * 2 * layer + 2 * 512 * 64
    attn = 2 * 4 * 16 * 4 * (t * (t + 1) // 2)
    for dt, peak, elem in (("float32", 67e12, 4), ("bfloat16", 989e12, 2)):
        weights = elem * (2 * layer + 512 * 64) / 3.35e12
        want = 100 * max(mm / peak + attn / 989e12, weights) / secs
        assert math.isclose(got[dt], want, rel_tol=1e-12)


def test_decode_roofline_by_hand():
    d = _dims(window=0)
    secs = 1e-5
    tr = Trace(window_s=1.0,
               kernels=[("decode_attention_kernel", 0, int(secs * 1e9))],
               spans=[("serve.decode:pos=99", 0, 10**6)])
    got = _load("decode_attn_roofline.serve").read(
        {"trace": tr, "run": _Run(d, cache_len=128), "dtype": "float32",
         "tf32": False})
    nbytes = 4 * 2 * 100 * 2 * 16 + 4 * 128 + 4 * 2 * 4 * 16
    want = 100 * 2 * nbytes / 3.35e12 / secs
    assert math.isclose(got, want, rel_tol=1e-12)


def test_train_mfu_and_flash_bwd_by_hand():
    d = _dims(vocab_size=512)
    tr = Trace(window_s=2.0, busy_s=1.5,
               kernels=[("bwd_dq_kernel", 0, 10**6),
                        ("bwd_dkdv_kernel", 10**6, 3 * 10**6)])
    ctx = {"trace": tr, "dims": d, "steps": 4, "window_s": 2.0, "batch": 2,
           "seq_len": 256, "dtype": "float32", "tf32": False}
    layer = 64 * 16 * (2 * 4 + 2 * 2) + 3 * 64 * 96
    mm = 6 * 2 * 256 * (2 * layer + 512 * 64)
    attn = 3 * 2 * 2 * 4 * 16 * 4 * 256 * 257 // 2
    want = 100 * (mm / 67e12 + attn / 989e12) / 0.5
    assert math.isclose(_load("train_mfu").read(ctx), want, rel_tol=1e-12)
    call = max(5 * 2 * 16 * 4 * 2 * 256 * 257 // 2 / 989e12,
               4 * 2 * 256 * 16 * 4 * 6 / 3.35e12)
    want = 100 * call * 2 * 4 / 3e-3
    got = _load("flash_bwd_roofline.train").read(ctx)
    assert math.isclose(got, want, rel_tol=1e-12)
    assert math.isclose(_load("device_idle_share.train").read(ctx), 0.25)


def test_trace_reduction_busy_gaps_and_spans():
    class Ev:
        def __init__(self, name, dev, s, dur):
            self._n, self._d, self._s, self._dur = name, dev, s, dur

        def name(self): return self._n
        def device_type(self): return "DeviceType." + self._d
        def start_ns(self): return self._s
        def duration_ns(self): return self._dur

    evs = [Ev("serve.prefill:T=8", "CPU", 0, 60),
           Ev("serve.prefill:T=8", "CUDA", 0, 60),      # annotation
           Ev("k1", "CUDA", 10, 20), Ev("k2", "CUDA", 25, 15),
           Ev("Memset (Device)", "CUDA", 60, 10), Ev("k1", "CUDA", 120, 5)]
    tr = __import__("portbench.trace", fromlist=["reduce"]).reduce(evs, 1.0)
    assert tr.busy_s == pytest.approx((30 + 10 + 5) / 1e9)
    assert [k[0] for k in tr.kernels] == ["k1", "k2", "k1"]
    assert tr.device_ops[0] == ["k1", 25 / 1e9]
    gaps = dict(tr.idle_gaps)
    assert gaps == {"serve.prefill": pytest.approx(20 / 1e9),
                    "host": pytest.approx(50 / 1e9)}
    assert [len(ks) for _, ks in tr.kernels_in("serve.prefill")] == [2]


def test_episodes_hold_the_same_requests_in_another_order():
    t = json.loads((ROOT / "portbench/traffic/qwen2_long_doc.json")
                   .read_text())
    a = gen.episode(t, 2**31 + 11, 0, 4)
    b = gen.episode(t, 2**31 + 11, 1, 4)
    kinds = lambda e: sorted((r["cls"], r["prompt_len"]) for r in e)  # noqa
    assert kinds(a) == kinds(b)
    assert sorted(r["home"] for r in a) == sorted(r["home"] for r in b)
    gaps = lambda e: sorted(round(y["t"] - x["t"], 9)  # noqa: E731
                            for x, y in zip([{"t": 0.0}] + e, e))
    assert gaps(a) == pytest.approx(gaps(b))
    assert [r["prompt_len"] for r in a] != [r["prompt_len"] for r in b]
    assert a == gen.episode(t, 2**31 + 11, 0, 4)
    # a run's episodes cycle through the pool of orders from the seed's
    # place in it: runs of any seed cover the same orders
    p = t["orders"]
    run = lambda s: sorted(str(gen.episode(t, s, e, 4))  # noqa: E731
                           for e in range(p))
    assert run(2**31 + 11) == run(3 * 10**9 + 7)
    n = t["requests_per_episode"]
    assert sum(r["hp"] for r in a) == gen.exact_counts(n, [2, 1])[0]
    # the mean rate is the file's
    assert a[-1]["t"] == pytest.approx(
        sum(-math.log1p(-(i + 0.5) / n) for i in range(n))
        / t["arrivals"]["rate_per_s"])


@pytest.mark.parametrize("traffic", ["qwen2_long_doc", "phi3_long_doc"])
def test_sample_is_fixed_by_the_seed_and_judges_hundreds_of_tokens(traffic):
    """The judged requests come from the seeded plans before the window:
    every LP request of the sample's episodes and the longest HP prompt
    among them, some hundreds of served tokens in all."""
    from portbench.serve import sample_plan
    t = json.loads((ROOT / f"portbench/traffic/{traffic}.json").read_text())
    a = sample_plan(t, 2**31 + 5, 4)
    assert a == sample_plan(t, 2**31 + 5, 4)
    assert a != sample_plan(t, 3 * 10**9 + 1, 4) or \
        t["check"]["hp_requests"] == sum(
            p["hp"] for e in range(t["check"]["episodes"])
            for p in gen.episode(t, 2**31 + 5, e, 4))
    plans = {(e, i): p for e in range(t["check"]["episodes"])
             for i, p in enumerate(gen.episode(t, 2**31 + 5, e, 4))}
    assert {k for k, p in plans.items() if not p["hp"]} <= a
    assert sum(plans[k]["hp"] for k in a) == t["check"]["hp_requests"]
    longest = max(p["prompt_len"] for p in plans.values() if p["hp"])
    assert any(plans[k]["prompt_len"] == longest and plans[k]["hp"]
               for k in a)
    assert sum(plans[k]["new_tokens"] for k in a) >= 300


def test_zipf_batches_rows_differ_and_repeat_by_seed():
    a = gen.zipf_batches(1000, 2, 64, 1.2, 2**31 + 3)
    b = gen.zipf_batches(1000, 2, 64, 1.2, 2**31 + 3)
    x, y = next(a), next(b)
    assert (x["tokens"] == y["tokens"]).all()
    assert (x["tokens"][0] != x["tokens"][1]).any()
    assert (x["labels"][:, :-1] == x["tokens"][:, 1:]).all()
    assert (x["labels"][:, -1] == -1).all()
    assert x["tokens"].max() < 1000


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_port_or_jax():
    for path in (ROOT / "portbench/reference").glob("*.py"):
        bad = _imports(path) & {"repro_torch", "repro", "jax", "jaxlib",
                                "flax"}
        assert not bad, (path.name, bad)


def test_harness_sources_name_no_jax_or_jax_package():
    for path in (ROOT / "portbench").rglob("*.py"):
        bad = _imports(path) & {"repro", "jax", "jaxlib", "flax"}
        assert not bad, (path, bad)


def test_a_run_loads_neither_jax_nor_the_jax_package(tiny_root):
    """A whole serving and training run on the CPU in a fresh process, with
    the JAX package on the path: the top-level names of sys.modules,
    compared whole (``repro_torch`` is not ``repro``)."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from conftest import run_cell\n"
        "from pathlib import Path\n"
        "run_cell(Path(%r), 'tiny.serve', trace=True)\n"
        "run_cell(Path(%r), 'tiny.train', seconds=0.2)\n"
        "from portbench import bench, control, sweep\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(bench.loaded_forbidden())\n"
        % (str(ROOT / "portbench/tests"), str(ROOT), str(tiny_root),
           str(tiny_root)))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600,
                       env={"PATH": "/usr/bin:/bin",
                            "PYTHONPATH": str(ROOT / "src")})
    assert p.returncode == 0, p.stderr[-3000:]
    mods, bad = p.stdout.strip().splitlines()[-2:]
    assert bad == "[]"
    assert "repro_torch" in mods
