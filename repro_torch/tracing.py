"""Spans inside the port, on the profiler's own clock.

A span is a ``record_function`` range, opened only while a
``torch.profiler`` session records: it lands on the Kineto timeline beside
the kernels, which is the one export.  With ``device=True`` a span also
records a pair of CUDA events on the current stream, kept in a bounded
list that :func:`device_spans` reads.  With no profiler recording,
:func:`span` reads one bool and returns a shared no-op context: it builds
no name (pass a callable to defer it), opens no range and records no event.

Every name starts with ``engine.`` (the serving engine) or ``train.`` (the
train step).

:data:`replays` counts the CUDA-graph replays of the serving steps
(``training/graphs.py``), with or without a profiler: a caller that reads
it before and after a step knows whether the step was replayed.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Callable, Union

import torch
from torch.autograd import profiler as _autograd_profiler

MAX_PAIRS = 4096          # CUDA event pairs kept; the oldest go first

replays = 0               # serving steps replayed from a CUDA graph

_OFF = contextlib.nullcontext()
_pairs: collections.deque = collections.deque(maxlen=MAX_PAIRS)


def on() -> bool:
    """True while a torch profiler records (the bool it sets and clears)."""
    return _autograd_profiler._is_profiler_enabled


def span(name: Union[str, Callable[[], str]], device: bool = False):
    """A ``record_function`` range named ``name`` (or ``name()``) while a
    profiler records, else a shared no-op context.  ``device=True`` also
    times the range's stream interval with a pair of CUDA events."""
    if not on():
        return _OFF
    return _span(name() if callable(name) else name, device)


@contextlib.contextmanager
def _span(name: str, device: bool):
    with torch.profiler.record_function(name):
        if not device:
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        _pairs.append((name, start, end))


def device_spans(prefix: str = "") -> list:
    """(name, device ms) of each kept event pair whose name starts with
    ``prefix``, after one synchronize."""
    sel = [p for p in _pairs if p[0].startswith(prefix)]
    if sel:
        torch.cuda.synchronize()
    return [(name, start.elapsed_time(end)) for name, start, end in sel]


def clear() -> None:
    """Drop the kept event pairs."""
    _pairs.clear()
