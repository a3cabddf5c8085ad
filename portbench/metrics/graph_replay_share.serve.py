"""Share of the window's prefill and decode steps that the program replayed
from a CUDA graph: the replays over the steps of every request of the
window (``ServeRequest.replays`` and ``steps``, kept by the engine)."""


def read(ctx):
    reqs = [r for _, _, r in ctx["run"].requests]
    steps = sum(getattr(r, "steps", 0) for r in reqs)
    if steps <= 0:
        return None
    return sum(r.replays for r in reqs) / steps
