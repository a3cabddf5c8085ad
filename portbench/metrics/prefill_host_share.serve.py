"""The part of the traced window's prefill steps in which the host, not the
card, set the pace: over the program's ``engine.prefill:T=<n>`` spans (the
step and the read of its token), the time outside the nested
``engine.read`` (the host's wait for the card), over the spans' whole
time."""
import bisect


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    reads = sorted((s, e) for name, s, e in tr.spans if name == "engine.read")
    starts = [s for s, _ in reads]
    total = waited = 0
    for name, s, e in tr.spans:
        if name.startswith("engine.prefill:T="):
            lo = bisect.bisect_left(starts, s)
            hi = bisect.bisect_right(starts, e)
            total += e - s
            waited += sum(b - a for a, b in reads[lo:hi])
    if total <= 0:
        return None
    return (total - waited) / total
