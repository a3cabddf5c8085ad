"""The readers of the program's own spans and counters, by hand on
synthetic traces and requests, and on a whole traced run on the CPU."""
from __future__ import annotations

import importlib.util
import math
from types import SimpleNamespace

import pytest
from conftest import ROOT, run_cell

from portbench.trace import SPAN_PREFIXES, Trace, _device_activity, reduce

SERVE = ("wasted_compute_share.serve", "prefill_host_share.serve",
         "decode_host_share.serve")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_"), ROOT / f"portbench/metrics/{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Ev:
    """A Kineto event as ``reduce`` sees it."""

    def __init__(self, name, dev):
        self._n, self._d = name, dev

    def name(self): return self._n
    def device_type(self): return "DeviceType." + self._d
    def start_ns(self): return 0
    def duration_ns(self): return 100


def test_program_spans_are_never_device_work():
    """The profiler puts the program's ranges on the device timeline too:
    its ``engine.`` and ``train.`` names are spans, never busy time."""
    slot = "engine.slot:rid=3:units=4:reserved_us=1000"
    names = (slot, "engine.admit:rid=3", "engine.admit:n=2",
             "engine.prefill:T=64", "engine.decode:pos=9", "engine.read",
             "train.grads", "train.optimizer")
    for name in names:
        assert name.startswith(SPAN_PREFIXES)
        assert not _device_activity(_Ev(name, "CUDA"))
    assert _device_activity(_Ev("gemm_kernel", "CUDA"))
    tr = reduce([_Ev(slot, "CUDA"), _Ev(slot, "CPU")], 1.0)
    assert tr.busy_s == 0 and tr.kernels == []
    assert tr.spans == [(slot, 0, 100)]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_host_share_by_hand(kind):
    step = {"prefill": "engine.prefill:T=64",
            "decode": "engine.decode:pos=9"}[kind]
    other = {"prefill": "engine.decode:pos=9",
             "decode": "engine.prefill:T=64"}[kind]
    spans = [("engine.slot:rid=1:units=2:reserved_us=9", 0, 10_000),
             (step, 0, 1000), ("serve.x", 10, 400), ("engine.read", 600, 1000),
             (step, 2000, 2200), ("engine.read", 2190, 2200),
             (other, 3000, 4000), ("engine.read", 3100, 4000)]
    read = _load(f"{kind}_host_share.serve").read
    got = read({"trace": Trace(window_s=1.0, spans=spans)})
    want = ((1000 - 400) + (200 - 10)) / 1200
    assert math.isclose(got, want, rel_tol=1e-12)
    assert read({"trace": Trace(window_s=1.0, spans=spans[-2:])}) is None
    assert read({"trace": None}) is None


def test_wasted_compute_share_by_hand():
    req = lambda c, w: SimpleNamespace(compute_s=c, wasted_s=w)  # noqa
    run = SimpleNamespace(requests=[(0, {}, req(2.0, 0.5)),
                                    (0, {}, req(1.0, 0.0)),
                                    (1, {}, req(1.0, 1.0))])
    read = _load("wasted_compute_share.serve").read
    assert read({"run": run}) == 1.5 / 4.0
    # requests without the counters (a program that lacks them)
    old = SimpleNamespace(requests=[(0, {}, SimpleNamespace(rid=1))])
    assert read({"run": old}) is None
    assert read({"run": SimpleNamespace(requests=[])}) is None


def test_optimizer_ms_by_hand(monkeypatch):
    import torch

    from repro_torch import tracing

    class Ev:
        def __init__(self, t): self.t = t
        def elapsed_time(self, end): return end.t - self.t

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    read = _load("optimizer_ms.train").read
    tracing.clear()
    try:
        assert read({"steps": 2}) is None
        tracing._pairs.extend([
            ("train.optimizer", Ev(0.0), Ev(90.0)),   # an earlier window
            ("train.grads", Ev(0.0), Ev(500.0)),
            ("train.optimizer", Ev(0.0), Ev(30.0)),
            ("train.optimizer", Ev(0.0), Ev(36.0))])
        assert read({"steps": 2}) == 33.0
        assert read({"steps": 0}) is None
    finally:
        tracing.clear()


def test_traced_serving_run_reads_the_program_spans(tiny_root):
    out = run_cell(tiny_root, "tiny.serve", trace=True)
    metrics = out["result"]["metrics"]
    for name in SERVE:
        assert 0.0 <= metrics[name]["value"] <= 1.0, name
        assert metrics[name]["unit"] == "share"
    spans = out["result"]["trace"].spans
    assert all(n.startswith(SPAN_PREFIXES) for n, _, _ in spans)
    names = {n.split(":")[0] for n, _, _ in spans}
    assert {"engine.admit", "engine.slot", "engine.prefill", "engine.decode",
            "engine.read", "serve.prefill", "serve.decode"} <= names
    assert "optimizer_ms.train" not in metrics
