"""The set-up's measured decode step (``measure_cost_model``, degree 2, the
measured one) at the cell's most common LP prompt length, in ms."""


def read(ctx):
    run = ctx["run"]
    lp = next(c for c in run.traffic["classes"] if c["priority"] == "low")
    length = lp["prompt_lens"][max(range(len(lp["weights"])),
                                   key=lambda i: lp["weights"][i])]
    return 1e3 * run.costs[length].decode[2].mean_s
