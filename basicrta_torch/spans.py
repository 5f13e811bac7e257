"""Spans and counters inside the program, kept in memory.

A span is one named interval of the program's work: its name, an id, the
id of the span open around it on the same thread (0 at the top), its start
and end in ``time.time_ns()`` and a dict of attributes. :func:`add` adds to
a counter among the attributes of the innermost open span, so a count is
kept at the boundary where its work happens.

Spans are recorded while :func:`enable` is in force or while
``torch.profiler`` is recording. Otherwise :func:`span` hands back one
shared context that does nothing, and :func:`add` returns at once: nothing
is allocated and nothing is recorded. With the recorder enabled under a
profiler, each span also opens ``torch.profiler.record_function(name)``,
so the profiler's trace shows the program's stages over the kernels
(``gibbs --profile``); a profiler alone gets no such ranges, and its
trace is what it would be without the recorder. ``time.time_ns()`` is the
clock the profiler stamps its device events with, so a span can be laid
against the card's activity. Spans never synchronize the card: a span that
ends on a host read (``.cpu()``, ``bool(...)``) waits for the card because
the program does. Records stay in memory until :func:`drain`, the newest
``MAX_RECORDS`` of them.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

from torch.autograd import profiler as _profiler

# spans kept undrained; older ones are dropped first
MAX_RECORDS = 1 << 16

_enabled = False
_records: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_ids = itertools.count(1)
_local = threading.local()


def enable() -> None:
    """Record spans from now on."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Stop recording (a running profiler still records)."""
    global _enabled
    _enabled = False


def recording() -> bool:
    """Whether a span opened now is recorded."""
    return _enabled or _profiler._is_profiler_enabled


def records() -> list:
    """The spans that have ended since the last drain, in the order they
    ended; the recorder keeps them."""
    return list(_records)


def drain() -> list:
    """The spans that have ended since the last drain, in the order they
    ended; the recorder keeps none of them."""
    out = []
    while _records:
        out.append(_records.popleft())
    return out


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One recorded span; a context manager that opens and closes it."""

    __slots__ = ("name", "id", "parent", "t0", "t1", "attrs", "_annotation")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.id = self.parent = self.t0 = self.t1 = 0
        self._annotation = None

    def __enter__(self) -> "Span":
        stack = _stack()
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else 0
        stack.append(self)
        if _enabled and _profiler._is_profiler_enabled:
            self._annotation = _profiler.record_function(self.name)
            self._annotation.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.time_ns()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
            self._annotation = None
        _stack().pop()
        _records.append(self)
        return False


# the one context :func:`span` hands back while nothing records
_OFF = contextlib.nullcontext()


def span(name: str, **attrs):
    """A context manager around one stage of the work, recorded as a
    :class:`Span` with ``attrs`` while the recorder is on."""
    if not recording():
        return _OFF
    return Span(name, attrs)


def add(counter: str, n=1) -> None:
    """Add ``n`` to ``counter`` on the innermost open span of this thread;
    nothing where no span is open."""
    stack = getattr(_local, "stack", None)
    if stack:
        attrs = stack[-1].attrs
        attrs[counter] = attrs.get(counter, 0) + n
