"""Share of the window's slot compute thrown away: the host seconds of the
attempts that preemption (``lose_work``) or a lost slice discarded, or that
never finished, over the host seconds of every slot's compute
(``ServeRequest.wasted_s`` and ``compute_s``, kept by the engine)."""


def read(ctx):
    reqs = [r for _, _, r in ctx["run"].requests]
    compute = sum(getattr(r, "compute_s", 0.0) for r in reqs)
    if compute <= 0:
        return None
    return sum(r.wasted_s for r in reqs) / compute
