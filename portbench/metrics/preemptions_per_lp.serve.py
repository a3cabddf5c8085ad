"""Preemptions the engine's ``Metrics`` counted, over LP requests sent."""


def read(ctx):
    out = ctx["outcomes"]
    if not out["lp_sent"]:
        return None
    return sum(m.preemptions for m in ctx["run"].metrics) / out["lp_sent"]
