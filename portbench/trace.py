"""The traced window: ``torch.profiler`` over the whole window, reduced to
device busy time, the operations that took most of it, the idle gaps by
the harness span the host was in, and the raw kernels and spans that the
per-layer readers take their numbers from.

Spans are ``record_function`` ranges that the harness opens around its
calls into the port (``serve.prefill:T=<n>``, ``serve.decode:pos=<n>``,
``train.step``, ...).  Each step of the port ends in a host read of its
result, so the kernels a span launched run inside its time range.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from dataclasses import dataclass, field

SPAN_PREFIXES = ("serve.", "train.", "engine.", "episode.")
TOP = 10


@dataclass
class Trace:
    window_s: float
    busy_s: float = 0.0
    kernels: list = field(default_factory=list)    # (name, start_ns, end_ns)
    spans: list = field(default_factory=list)      # (name, start_ns, end_ns)
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)

    def kernels_in(self, prefix: str) -> list:
        """(span name, [kernels starting inside it]) for each span whose name
        starts with ``prefix``."""
        ks = sorted(self.kernels, key=lambda k: k[1])
        starts = [k[1] for k in ks]
        out = []
        for name, s, e in self.spans:
            if name.startswith(prefix):
                lo = bisect.bisect_left(starts, s)
                hi = bisect.bisect_right(starts, e)
                out.append((name, ks[lo:hi]))
        return out

    def kernel_seconds(self, *names: str) -> tuple:
        """(seconds, launches) of the kernels whose name holds any of
        ``names``."""
        sel = [k for k in self.kernels if any(n in k[0] for n in names)]
        return sum(k[2] - k[1] for k in sel) / 1e9, len(sel)


def _device_activity(ev) -> bool:
    """A kernel, copy or memset on the card (the profiler also puts the
    spans' annotations on the device's timeline: those are not work)."""
    return (str(ev.device_type()).endswith("CUDA") and ev.duration_ns() > 0
            and not ev.name().startswith(SPAN_PREFIXES))


def reduce(events, window_s: float) -> Trace:
    """Kineto events of a profiled window -> a :class:`Trace`."""
    tr = Trace(window_s=window_s)
    dev = []
    for ev in events:
        name = ev.name()
        if _device_activity(ev):
            dev.append((name, ev.start_ns(), ev.start_ns() + ev.duration_ns()))
        elif (name.startswith(SPAN_PREFIXES)
              and str(ev.device_type()).endswith("CPU")):
            tr.spans.append((name, ev.start_ns(),
                             ev.start_ns() + ev.duration_ns()))
    # kernels, memsets and copies all occupy the device
    tr.kernels = [d for d in dev if not d[0].startswith(("Memcpy", "Memset"))]
    dev.sort(key=lambda d: d[1])
    by_name: dict = {}
    for name, s, e in dev:
        by_name[name] = by_name.get(name, 0) + (e - s)
    tr.device_ops = [[n[:200], ns / 1e9] for n, ns in
                     sorted(by_name.items(), key=lambda x: -x[1])[:TOP]]
    # union of busy intervals, and the gaps between them
    busy, gaps = 0, []
    cur_s = cur_e = None
    for _, s, e in dev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    tr.busy_s = busy / 1e9
    tr.idle_gaps = _gaps_by_span(gaps, tr.spans)
    return tr


def _gaps_by_span(gaps: list, spans: list) -> list:
    """Idle seconds grouped by the innermost harness span around each gap's
    middle ("host" where none is), the largest groups first."""
    spans = sorted(spans, key=lambda s: s[1])
    starts = [s[1] for s in spans]
    out: dict = {}
    for s, e in gaps:
        mid = (s + e) // 2
        i = bisect.bisect_right(starts, mid)
        best = None
        for name, a, b in spans[max(0, i - 64):i]:   # spans nest shallowly
            if a <= mid <= b and (best is None or a >= best[1]):
                best = (name, a)
        key = best[0].split(":")[0] if best else "host"
        out[key] = out.get(key, 0) + (e - s)
    return [[k, ns / 1e9] for k, ns in
            sorted(out.items(), key=lambda x: -x[1])[:TOP]]


@contextlib.contextmanager
def traced(enabled: bool, torch):
    """Profile the block when ``enabled``; yields a holder whose ``trace``
    is set on exit."""
    holder = type("Holder", (), {"trace": None})()
    if not enabled:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    t0 = time.perf_counter()
    try:
        yield holder
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        prof.__exit__(None, None, None)
    holder.trace = reduce(prof.profiler.kineto_results.events(), window_s)


def span(enabled: bool, name: str):
    """A ``record_function`` range where tracing is on, else nothing."""
    if not enabled:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(name)
