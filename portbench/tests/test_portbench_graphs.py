"""The reader of the program's graph-replay counters, by hand on synthetic
requests and on a whole traced run on the CPU (where every step is eager)."""
from __future__ import annotations

import importlib.util
from types import SimpleNamespace

from conftest import ROOT, run_cell

NAME = "graph_replay_share.serve"


def _read(ctx):
    spec = importlib.util.spec_from_file_location(
        NAME.replace(".", "_"), ROOT / f"portbench/metrics/{NAME}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def _run(*reqs):
    return {"run": SimpleNamespace(requests=[(i % 2, {}, r)
                                             for i, r in enumerate(reqs)])}


def test_graph_replay_share_by_hand():
    """Σ replays over Σ steps of the window's requests; nothing where no
    request counts steps (a program without the counters, or no step)."""
    req = lambda s, r: SimpleNamespace(steps=s, replays=r)  # noqa: E731
    assert _read(_run(req(4, 2), req(1, 1), req(0, 0), req(5, 5))) == 8 / 10
    assert _read(_run(req(3, 0))) == 0.0
    assert _read(_run(SimpleNamespace(rid=1))) is None
    assert _read(_run(req(0, 0))) is None
    assert _read(_run()) is None


def test_traced_serving_run_reads_the_replay_share(tiny_root):
    """On the CPU the steps run eagerly: the share reads 0, as a share."""
    out = run_cell(tiny_root, "tiny.serve", trace=True)
    metric = out["result"]["metrics"][NAME]
    assert metric["value"] == 0.0 and metric["unit"] == "share"
