"""Spans inside the program, on the profiler's clock.

``span(name, **attrs)`` marks where the transient step and the Krylov
solves spend their host time: the step's pieces, each solver's operator,
preconditioner and host-read boundaries.  A span is recorded only while a
``torch.profiler`` is recording (``torch.autograd._profiler_enabled()``):
the benchmark's traced units, an operator's ``utils.profiling.
maybe_profile``.  Otherwise ``span`` makes that one check and returns a
shared null context.

A recorded span appends to a bounded in-memory list (:func:`records`):
its name, its start and end from ``time.time_ns()`` -- the clock on which
the profiler puts its host events and onto which it maps the device's --
the index of its parent span, the index of its root span (the unit that
caused it) and the attributes given at entry or set at exit
(``sp.set(iterations=...)``).  It also opens ``record_function("ns:" +
name)``, so that an exported trace shows it.  Host reads are spans named
``<solver>.read``; there is no counter.  Past ``MAX_RECORDS`` spans are
counted, not kept (:func:`dropped`), until :func:`reset`.

``@traced(name)`` runs a whole function inside a span and sets the span's
``iterations`` from a result that has them (the solvers' roots, the
models' pieces); ``wrap(name, op)`` gives an operator that runs inside a
span, or ``op`` itself when no profiler records as it is wrapped.

Spans are single-threaded: the stack of open spans is the module's, and
each rank of a sharded solve is a process of its own.
"""

from __future__ import annotations

import functools
import time

import torch
from torch.autograd import profiler as _profiler

__all__ = ["PREFIX", "MAX_RECORDS", "Span", "span", "traced", "wrap",
           "records", "dropped", "reset"]

PREFIX = "ns:"
MAX_RECORDS = 1 << 19  # spans kept; later ones are not recorded

_enabled = torch.autograd._profiler_enabled
_records: list = []
_stack: list = []
_dropped = [0, None]  # spans not kept past MAX_RECORDS; the first's start


class _Null:
    """The context of a span that is not recorded."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_NULL = _Null()


class Span:
    """One recorded span: ``name``, ``start`` / ``end`` (ns of
    ``time.time_ns()``; ``end`` None while open), ``parent`` and ``root``
    (indices into :func:`records`; ``parent`` None for a root, whose
    ``root`` is its own index), ``attrs``."""

    __slots__ = ("name", "start", "end", "parent", "root", "attrs", "_rf")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.start = self.end = None

    def set(self, **attrs):
        self.attrs.update(attrs)

    def __enter__(self):
        if len(_records) >= MAX_RECORDS:
            self._rf = None
            if not _dropped[0]:
                _dropped[1] = time.time_ns()
            _dropped[0] += 1
            return self
        index = len(_records)
        if _stack:
            self.parent = _stack[-1]
            self.root = _records[self.parent].root
        else:
            self.parent, self.root = None, index
        _records.append(self)
        _stack.append(index)
        self._rf = _profiler.record_function(PREFIX + self.name)
        self.start = time.time_ns()
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is None:
            return False
        self._rf.__exit__(*exc)
        self.end = time.time_ns()
        self._rf = None
        if _stack and _records[_stack[-1]] is self:
            _stack.pop()
        return False


def span(name: str, **attrs):
    """A context for the span ``name``: recorded while a profiler records,
    else the shared null context.  Either has ``set(**attrs)``."""
    if not _enabled():
        return _NULL
    return Span(name, attrs)


def traced(name: str):
    """Decorator: each call inside the span ``name``; a result with an
    ``iterations`` attribute sets the span's ``iterations``."""
    def decorate(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _enabled():
                return fn(*args, **kwargs)
            with Span(name, {}) as sp:
                out = fn(*args, **kwargs)
                its = getattr(out, "iterations", None)
                if its is not None:
                    sp.set(iterations=int(its))
                return out

        return call

    return decorate


def wrap(name: str, op):
    """``op`` run inside the span ``name`` while a profiler records; ``op``
    itself when none records now."""
    if not _enabled():
        return op

    def call(*args):
        with span(name):
            return op(*args)

    return call


def records() -> list:
    """The recorded spans in the order they opened (a new list of the
    :class:`Span` objects)."""
    return list(_records)


def dropped() -> tuple:
    """(spans not kept since the last :func:`reset` because the list was
    full, the ``time.time_ns()`` at which the first of them opened or
    None)."""
    return tuple(_dropped)


def reset() -> None:
    """Forget every recorded span and the count of those not kept (spans
    still open are closed without being kept)."""
    _records.clear()
    _stack.clear()
    _dropped[:] = [0, None]
