"""Spans at the port's layer boundaries, off unless turned on.

    from autodiffusion_tpu_torch.utils import trace

    trace.enable(True)
    with trace.span("adt.sampler.loop", rows=n, steps=k):
        ...
    records = trace.take()

Off (the default), ``span`` checks one flag and hands back one shared null
context: no record, no clock read, no profiler range. On, each span
appends a :class:`Span` record (host start and end on
``time.perf_counter_ns``, the index of its parent, its trace id, its
attributes) and opens ``torch.profiler.record_function(name)``, so under
any torch.profiler run the span lies on the profiler's clock beside the
kernels, with the profiler's own device-side copy of the range.

Spans of one request share a trace id. A root span takes the id its
caller gives (a fitness chunk gives its ``eval_count``) or a fresh one
(-1, -2, ...); a child takes its parent's. Counts ride on the spans as
attributes (the rows of a sampler loop, the images of a features call).

Records stay in memory until ``take()`` returns and clears them: whoever
turns spans on takes the records. Nothing here writes a file, reads the
device, or synchronises it. Spans are opened from one thread (the one
that runs the sampler); ``take()`` is called with no span open.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import time
from typing import Any, Dict, List, Optional

import torch

__all__ = ["Span", "span", "enable", "take"]


@dataclasses.dataclass
class Span:
    """One span: ``parent`` is the index of the enclosing span among the
    records (-1 at a root); ``end_ns`` is 0 while the span is open."""
    name: str
    start_ns: int
    end_ns: int
    parent: int
    trace_id: int
    attrs: Dict[str, Any]


_on = False
_records: List[Span] = []
_open: List[int] = []
_fresh = itertools.count(-1, -1)
_NULL = contextlib.nullcontext()


class _Open:
    __slots__ = ("name", "trace_id", "attrs", "record", "range")

    def __init__(self, name: str, trace_id: Optional[int], attrs):
        self.name, self.trace_id, self.attrs = name, trace_id, attrs

    def __enter__(self):
        parent = _open[-1] if _open else -1
        trace_id = self.trace_id
        if trace_id is None:
            trace_id = (_records[parent].trace_id if parent >= 0
                        else next(_fresh))
        self.record = Span(self.name, time.perf_counter_ns(), 0, parent,
                           trace_id, self.attrs)
        _open.append(len(_records))
        _records.append(self.record)
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        return self.record

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        self.record.end_ns = time.perf_counter_ns()
        _open.pop()
        return False


def span(name: str, trace_id: Optional[int] = None, **attrs):
    """A context manager around one piece of work named ``name``
    (``adt.<layer>.<what>``), with ``attrs`` kept on its record."""
    if not _on:
        return _NULL
    return _Open(name, trace_id, attrs)


def enable(on: bool = True) -> None:
    """Turn spans on or off; records already taken are unaffected."""
    global _on
    _on = bool(on)


def take() -> List[Span]:
    """The records since the last ``take()``, in the order the spans
    opened; the list is cleared."""
    out = list(_records)
    _records.clear()
    return out
