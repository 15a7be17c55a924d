"""Spans and counters of the port's own work, and a device trace.

One recorder, always on and bounded:

- ``root(name, **attrs)`` opens a root span: one build
  (``SuffixTable.new``, a ``build`` root), one rank's part of a sharded
  build (``parallel/dist_build.py::build_table``, a ``sharded_build``
  root on every rank) or one serving drain (``serve.Batcher``). Each
  root gets an id; ``with root(...) as r`` gives its record.
- ``span(name, **attrs)`` opens a child span of the open root of this
  thread; its parent is the innermost span open around it.
- ``count(name, n=1)`` adds to a counter of the open root;
  ``annotate(**attrs)`` sets attributes of it.
- ``finished(name)``: the last ``MAX_ROOTS`` closed roots of that name
  (each name keeps its own), oldest first, each with its duration, its
  seconds and count of spans by name, and its counters.

A span or counter with no root open on its thread records nothing. Every
span, roots included, also opens ``torch.profiler.record_function(name)``
for its duration, so it shows under its own name in any profiler trace.
Spans are stamped with ``time.time_ns()``, the wall clock onto which a
profiler trace's ``baseTimeNanoseconds`` maps. A span closed by an
exception carries ``error=True``.

``device_trace`` wraps a region in ``torch.profiler`` and writes its
Chrome trace. The build and LCP code also marks its passes with
``record_function`` scopes (``P0``-``P6``, ``T1``-``T3``, ``L1``-``L4``,
...), which show in that trace inside the spans.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import deque

import torch
from torch.profiler import record_function

MAX_ROOTS = 256  # closed roots kept, for each name

_tls = threading.local()
_ids = itertools.count(1)
_closes = itertools.count()
_closed: dict[str, deque] = {}  # name -> (close number, root), oldest first
_closed_lock = threading.Lock()


def _stack() -> list:
    """This thread's open spans, as (span id, root) pairs."""
    try:
        return _tls.stack
    except AttributeError:
        _tls.stack = []
        return _tls.stack


class Span:
    """A span. A root (``root()``) opens with no parent and holds the
    record of its work: ``id``, ``name``, ``attrs``, ``start_ns``,
    ``end_ns``, ``error``, the closed child spans (``spans``: dicts with
    ``id``, ``parent``, ``name``, ``start_ns``, ``end_ns``, ``attrs``,
    ``error``) and ``counters``. A child (``span()``) attaches to the open
    root of its thread, if any."""

    __slots__ = ("id", "name", "attrs", "is_root", "root", "parent",
                 "start_ns", "end_ns", "error", "spans", "counters", "_rf")

    def __init__(self, name: str, attrs: dict, is_root: bool):
        self.id = next(_ids)
        self.name = name
        self.attrs = attrs
        self.is_root = is_root
        self.start_ns = self.end_ns = None
        self.error = False
        if is_root:
            self.spans: list[dict] = []
            self.counters: dict = {}

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def __enter__(self) -> "Span":
        stack = _stack()
        if self.is_root:
            self.parent, self.root = None, self
        elif stack:
            self.parent, self.root = stack[-1]
        else:
            self.root = None
        if self.root is not None:
            stack.append((self.id, self.root))
        self._rf = record_function(self.name)
        self._rf.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, et, ev, tb):
        self.end_ns = time.time_ns()
        self._rf.__exit__(et, ev, tb)
        self._rf = None
        self.error = et is not None
        if self.root is None:
            return False
        _stack().pop()
        if self.is_root:
            with _closed_lock:
                kept = _closed.setdefault(self.name, deque(maxlen=MAX_ROOTS))
                kept.append((next(_closes), self))
        else:
            self.root.spans.append({
                "id": self.id, "parent": self.parent, "name": self.name,
                "start_ns": self.start_ns, "end_ns": self.end_ns,
                "attrs": self.attrs, "error": self.error})
        return False

    def summary(self) -> dict:
        """A closed root's record, with seconds and count of spans by
        name."""
        span_s: dict = {}
        span_n: dict = {}
        for s in self.spans:
            k = s["name"]
            dt = (s["end_ns"] - s["start_ns"]) / 1e9
            span_s[k] = span_s.get(k, 0.0) + dt
            span_n[k] = span_n.get(k, 0) + 1
        return {"id": self.id, "name": self.name, "attrs": dict(self.attrs),
                "start_ns": self.start_ns, "end_ns": self.end_ns,
                "seconds": self.seconds, "error": self.error,
                "span_s": span_s, "span_n": span_n,
                "counters": dict(self.counters), "spans": list(self.spans)}


def root(name: str, **attrs) -> Span:
    """A root span: ``with root("build", n=...) as r``; ``r`` is its
    record, closed and kept when the block ends. A root opened inside
    another takes the spans and counters of its own block."""
    return Span(name, attrs, is_root=True)


def span(name: str, **attrs) -> Span:
    """A child span of this thread's open root (only a profiler scope
    when none is open)."""
    return Span(name, attrs, is_root=False)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of this thread's open root."""
    stack = _stack()
    if stack:
        c = stack[-1][1].counters
        c[name] = c.get(name, 0) + n


def annotate(**attrs) -> None:
    """Set attributes of this thread's innermost open root."""
    stack = _stack()
    if stack:
        stack[-1][1].attrs.update(attrs)


def finished(name: str | None = None) -> list[dict]:
    """The kept closed roots named ``name`` (of every name, for
    ``None``), in the order they closed, as ``Span.summary()`` dicts."""
    with _closed_lock:
        if name is not None:
            kept = list(_closed.get(name, ()))
        else:
            kept = sorted(r for d in _closed.values() for r in d)
    return [r.summary() for _, r in kept]


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Wrap a region in ``torch.profiler`` (CPU, plus CUDA when present)
    and write its Chrome trace to ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
