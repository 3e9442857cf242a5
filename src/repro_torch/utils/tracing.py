"""Spans of the port's host work, laid on the clock of the profiler's trace.

A span is a named interval of host time with the span that was open around
it (its parent) and a few attributes. The spans of one barrier tick carry
or sit under its ``tick``, those of one tier batch share ``seq``, and a
request's span carries its ``rid``::

    with tracing.span("tick.plan"):
        plan = sched.plan_tick()
    tracing.record("tier.request", q.submitted_at, q.finished_at, rid=q.rid)

Spans are recorded only while a ``torch.profiler`` session is active, as
the profiler's own flag (``torch.autograd.profiler._is_profiler_enabled``)
says. Outside a session ``span`` returns one shared inert object and
``record`` returns at once: a span site reads the flag and nothing else,
no clock and no new object. Sites on the main path name no attributes in
the call; they add them with ``set`` on a span that is recording
(``if sp: sp.set(...)``), so nothing is built outside a session. Each
session starts a fresh in-memory buffer, begun and closed through the
profiler's own start and stop hooks; ``spans()`` returns the finished
spans of the newest one, so a second traced run in one process reads only
its own. On a torch without those hooks sessions cannot be told apart:
importing this module warns, and ``spans()`` raises.

The recorder times with ``time.perf_counter`` (the clock of the serving
tier's request stamps; ``record`` takes its values) and ``spans()`` moves
every time onto the clock of the profiler's events, the Unix clock in
nanoseconds (``time.time_ns``), by one offset taken when the session
starts, so each span can be laid beside the device kernels of the same
trace. The buffer is process-wide, as the profiler is.
"""
from __future__ import annotations

import threading
import time
import warnings
from typing import Dict, List, NamedTuple, Optional

import torch.autograd.profiler as _profiler


class Span(NamedTuple):
    """A finished span: ``start_ns``/``end_ns`` on the profiler's clock,
    ``parent`` the index of the enclosing span in the same list."""

    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    attrs: Dict[str, object]

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class _Session:
    """One profiler session's buffer and its clock offset."""

    def __init__(self):
        p0 = time.perf_counter()
        wall = time.time_ns()
        p1 = time.perf_counter()
        self.perf0, self.wall0 = 0.5 * (p0 + p1), wall
        self.buf: List["_Open"] = []
        self.closed = False
        self._local = threading.local()

    def stack(self) -> List["_Open"]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def to_ns(self, t: float) -> int:
        return self.wall0 + round((t - self.perf0) * 1e9)


class _Open:
    """A span being recorded: what ``span`` yields inside a session."""

    __slots__ = ("name", "attrs", "start", "end", "parent", "_session")

    def __init__(self, session: _Session, name: str, attrs: Dict[str, object]):
        self._session, self.name, self.attrs = session, name, attrs
        self.start = self.end = None
        self.parent: Optional[_Open] = None

    def __enter__(self) -> "_Open":
        stack = self._session.stack()
        self.parent = stack[-1] if stack else None
        self._session.buf.append(self)
        stack.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.perf_counter()
        stack = self._session.stack()
        if self in stack:  # children left open are closed with it
            del stack[stack.index(self):]
        return False

    def set(self, **attrs) -> None:
        """Add attributes (also after the span has ended)."""
        self.attrs.update(attrs)


class _Off:
    """The inert span of every site outside a session; false in a test."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()
_session: Optional[_Session] = None


def recording() -> bool:
    """Whether spans are being recorded: a profiler session is active."""
    return _profiler._is_profiler_enabled


def _begin() -> _Session:
    global _session
    _session = _Session()
    return _session


def _live() -> _Session:
    """The open session; one is begun here if the profiler started before
    this module could see it start."""
    s = _session
    return _begin() if s is None or s.closed else s


def span(name: str, **attrs):
    """A context manager recording the host time of its body as a span
    named ``name``, inside a profiler session; the object it yields takes
    more attributes with ``set``. Outside a session, one inert object."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Open(_live(), name, attrs)


def record(name: str, start: float, end: float, parent=None, **attrs):
    """Record a span whose ``start`` and ``end`` (``time.perf_counter``
    seconds) the caller already took; its parent is ``parent`` (a span that
    ``record`` returned) or else the span open now. Returns the span, or
    None outside a session."""
    if not _profiler._is_profiler_enabled:
        return None
    s = _live()
    sp = _Open(s, name, attrs)
    stack = s.stack()
    sp.parent = parent if parent is not None else (stack[-1] if stack else None)
    sp.start, sp.end = start, end
    s.buf.append(sp)
    return sp


def spans() -> List[Span]:
    """The newest session's finished spans, in the order they began (or
    were recorded), on the profiler's clock; a parent still open when this
    is read is given as None. Raises where the profiler's start and stop
    hooks could not be installed."""
    if not _HOOKED:
        raise RuntimeError("repro_torch.utils.tracing: this torch has no profiler start/stop "
                           "hooks, so traced sessions cannot be told apart")
    s = _session
    if s is None:
        return []
    done = [o for o in s.buf if o.end is not None]
    index = {id(o): i for i, o in enumerate(done)}
    return [Span(o.name, s.to_ns(o.start), s.to_ns(o.end),
                 None if o.parent is None else index.get(id(o.parent)), dict(o.attrs))
            for o in done]


def _install() -> bool:
    """Begin a session when the profiler starts and close it when it stops,
    through the profiler's own start and stop hooks (once per process).
    Whether the hooks are in place."""
    start = getattr(_profiler, "_run_on_profiler_start", None)
    stop = getattr(_profiler, "_run_on_profiler_stop", None)
    if start is None or stop is None:
        warnings.warn("torch.autograd.profiler has no _run_on_profiler_start/_stop hooks: "
                      "repro_torch.utils.tracing.spans() will raise", RuntimeWarning)
        return False
    if getattr(start, "_begins_spans", False):
        return True

    def on_start():
        start()
        _begin()

    def on_stop():
        if _session is not None:
            _session.closed = True
        stop()

    on_start._begins_spans = True
    _profiler._run_on_profiler_start = on_start
    _profiler._run_on_profiler_stop = on_stop
    return True


_HOOKED = _install()
