"""LP requests done by their deadline, over LP requests sent in the window
(``PreemptiveServingEngine`` request states on the engine's clock: the
paper's frames fully classified; the scheduler and its policy decide
them)."""


def read(ctx):
    out = ctx["outcomes"]
    if not out["lp_sent"]:
        return None
    return out["lp_done"] / out["lp_sent"]
