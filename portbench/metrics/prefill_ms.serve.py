"""The set-up's measured prefill (``measure_cost_model``, host clock fenced
by a synchronize, mean of its reps) at the cell's most common HP prompt
length, in ms."""


def read(ctx):
    run = ctx["run"]
    hp = next(c for c in run.traffic["classes"] if c["priority"] == "high")
    length = hp["prompt_lens"][max(range(len(hp["weights"])),
                                   key=lambda i: hp["weights"][i])]
    return 1e3 * run.costs[length].prefill[1].mean_s
