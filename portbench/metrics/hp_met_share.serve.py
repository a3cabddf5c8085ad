"""HP requests done by their deadline, over HP requests sent in the window
(``PreemptiveServingEngine`` request states; the scheduler and its
policy decide them)."""


def read(ctx):
    out = ctx["outcomes"]
    if not out["hp_sent"]:
        return None
    return out["hp_done"] / out["hp_sent"]
