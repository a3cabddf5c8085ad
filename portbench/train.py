"""A training cell: the port's ``make_train_step`` (AdamW in place, per-layer
recompute, the flash kernel's backward) on next-token batches of a Zipf
stream, steps back to back.

Set-up builds the one train step with its weights (from the seed) and
optimizer state and drives it through its first ``check.steps`` steps with
the window's own call and feed.  From those steps it keeps what the
reference is held against: each step's loss, every leaf's norm of the first
gradient as the optimizer got it (from its first moment after step 1), and
every leaf's norm of its change over those steps.  The window then goes on
with the same object.  Once the window has closed and the program's state is
freed, the reference makes the same weights, takes the same batches, and
follows the same steps.
"""
from __future__ import annotations

import gc
import statistics
import time

import torch

from . import bench, gen
from .reference import train as ref_train
from .trace import span, traced
from .weights import make_weights

RULE_OUT = 1e-3      # a leaf whose reference gradient is under this share of
                     # the median leaf's moves by round-off alone


def _norms(tree: dict) -> dict:
    return {n: float(t.detach().double().norm())
            for n, t in ref_train.leaves(tree)}


def compare(prog: dict, ref: dict) -> dict:
    """The three numbers compared: the worst step's relative loss gap, and
    by the worst leaf the gap of the gradient's and of the change's norms,
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger (leaves whose reference gradient is nought to
    rounding left out of the change)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                   ref["loss"]))
    gmed = statistics.median(ref["grad"].values())
    grad = max(abs(prog["grad"][n] - g) / max(g, gmed)
               for n, g in ref["grad"].items())
    moved = [n for n, g in ref["grad"].items() if g >= RULE_OUT * gmed]
    dmed = statistics.median(ref["delta"][n] for n in moved)
    delta = max(abs(prog["delta"][n] - ref["delta"][n])
                / max(ref["delta"][n], dmed) for n in moved)
    return {"loss_gap": loss, "grad_gap": grad, "delta_gap": delta,
            "left_out": sorted(set(ref["grad"]) - set(moved))}


def program(cell: bench.Cell, seed: int, device, fault: str | None = None):
    """The train step object with its state, and its batches."""
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.steps import loss_and_grads, make_train_step
    tr = cell.traffic
    cfg = bench.port_config(cell.config)
    dev = torch.device(device)
    params = make_weights(cfg, seed, dev)
    for _, t in ref_train.leaves(params):
        t.requires_grad_(True)
    opt = AdamWConfig(**tr["optimizer"])
    state = init_opt_state(opt, params)
    step = make_train_step(cfg, opt, remat=tr["remat"], device=dev)
    if fault == "frozen":            # a step that returns its state unchanged
        def step(p, s, b):
            loss, parts, _ = loss_and_grads(p, cfg, b, remat=tr["remat"])
            return p, s, {"loss": loss, **parts}
    elif fault == "half":            # half the batch left out
        inner = step

        def step(p, s, b):
            half = {k: v[: len(v) // 2] for k, v in b.items()}
            return inner(p, s, half)
    batches = gen.zipf_batches(cfg.vocab_size, tr["batch"], tr["seq_len"],
                               tr["zipf_a"], seed)
    return cfg, params, state, step, batches


def first_steps(params, state, step, batches, n: int, b1: float, dev):
    """Steps 1..n through the window's call and feed -> (the batches, the
    program's readings)."""
    start = {k: t.detach().clone() for k, t in ref_train.leaves(params)}
    seen, out = [], {"loss": [], "grad": {}, "delta": {}}
    for i in range(1, n + 1):
        b = next(batches)
        seen.append(b)
        params, state, m = step(params, state, b)
        out["loss"].append(float(m["loss"]))
        if i == 1:
            out["grad"] = {k: v / (1 - b1)
                           for k, v in _norms(state["m"]).items()}
    with torch.no_grad():
        out["delta"] = {k: float((t.detach() - start[k]).double().norm())
                        for k, t in ref_train.leaves(params)}
    del start
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return seen, out


def reference(cell: bench.Cell, seed: int, device, batches: list,
              precision: str = "f32") -> dict:
    """The plain reference's readings over the same steps, from weights made
    anew from the seed."""
    cfg = bench.port_config(cell.config)
    model = bench.reference_model(cell.config)
    dims = model.Dims.from_published(bench.values(cell.config))
    w = make_weights(cfg, seed, torch.device(device))
    opt = dict(cell.traffic["optimizer"])
    return ref_train.run_steps(model, w, dims, batches, opt, precision)


def run(cell: bench.Cell, seed: int, seconds: float, trace: bool,
        t_start: float, device="cuda", fault: str | None = None) -> dict:
    tr = cell.traffic
    dev = torch.device(device)
    cfg, params, state, step, batches = program(cell, seed, dev, fault)
    seen, prog = first_steps(params, state, step, batches,
                             tr["check"]["steps"], tr["optimizer"]["b1"],
                             dev)
    setup_s = time.perf_counter() - t_start
    steps = 0
    with traced(trace, torch) as holder:
        t0 = time.perf_counter()
        while True:
            with span(trace, "train.batch"):
                b = next(batches)
            with span(trace, "train.step"):
                params, state, _ = step(params, state, b)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    del params, state, step, batches
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = reference(cell, seed, dev, seen)
    c = compare(prog, ref)
    lim = tr["check"]
    checks = {k: {"value": c[k], "limit": lim[k]}
              for k in ("loss_gap", "grad_gap", "delta_gap")}
    correct = all(checks[k]["value"] <= checks[k]["limit"] for k in checks)
    result = {"correct": bool(correct), "attempted": steps, "failed": 0}
    tokens = steps * tr["batch"] * tr["seq_len"]
    if trace:
        dims = bench.reference_model(cell.config).Dims.from_published(
            bench.values(cell.config))
        ctx = {"dims": dims, "trace": holder.trace, "steps": steps,
               "window_s": window_s, "batch": tr["batch"],
               "seq_len": tr["seq_len"],
               "dtype": cfg.param_dtype, "tf32": False}
        result["metrics"] = bench.read_per_layer(cell, ctx)
        result["breakdown"] = {"device_ops": holder.trace.device_ops,
                               "idle_gaps": holder.trace.idle_gaps}
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        vals = {"train_tok_s": tokens / window_s, "setup_s": setup_s}
        result["metrics"] = {k: {"value": v, "unit": units[k]}
                             for k, v in vals.items() if k in units}
    result["peak"] = peak
    result["trace"] = holder.trace
    result["info"] = {"steps": steps, "window_s": window_s,
                      "left_out": c["left_out"], "prog_loss": prog["loss"],
                      "ref_loss": ref["loss"]}
    return {"result": result, "checks": checks}
