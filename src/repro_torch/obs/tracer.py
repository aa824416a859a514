"""Span/counter/instant tracer with an explicit no-op mode.

Design constraints, in order:

  1. **Disabled is free.** Tracing is off by default and the instrumented
     hot paths (`runtime.step_client`, `socket.send`, `bus.deliver`, the
     wire codecs) run per message / per step. Every module-level hook
     (``span``/``instant``/``counter``/``flow_*``) is one global read and
     an early return of a shared immutable no-op context manager — no
     allocation beyond the kwargs dict, no lock, no clock read. The
     acceptance bound is < 2% on the in-process ``quick`` preset.
  2. **Enabled is bounded.** Events land in a ring buffer
     (``capacity`` events, oldest dropped first, drops counted) behind a
     lock, so a run that produces millions of events degrades to a
     truncated trace instead of unbounded memory.
  3. **Timestamps are local.** ``time.perf_counter()`` — monotonic but
     with a per-process arbitrary epoch. Cross-process alignment is the
     merge step's job (`export.merge_traces`), using rendezvous-handshake
     *anchors* recorded here via ``set_anchor``.

Event kinds map 1:1 onto Chrome trace-event phases (`export.py`):
``"X"`` complete span, ``"i"`` instant, ``"C"`` counter, ``"s"``/``"f"``
flow start/finish. A flow links one socket send span to its delivery
span across processes; both ends derive the same 64-bit id from
``flow_id(src, dst, sent_step)`` so no coordination is needed.

Usage::

    from repro_torch.obs import trace

    trace.enable(rank=3)                      # or leave disabled (no-op)
    with trace.span("encode", client=1, nbytes=n):
        ...
    trace.instant("gate_skip", client=1)
    trace.counter("mailbox", 4, client=1)
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = [
    "Tracer", "active", "complete", "counter", "disable", "enable",
    "flow_end", "flow_id", "flow_start", "get", "instant", "now", "span",
    "set_anchor",
]


def flow_id(src: int, dst: int, sent_step: int) -> int:
    """Deterministic 64-bit flow id for one frame on one edge: both the
    sending and the receiving process compute the same id from what the
    frame header carries, so send→delivery arrows need no handshake.
    (One publish produces at most one frame per (src, dst, step).)"""
    return (((src & 0xFFFF) << 48) | ((dst & 0xFFFF) << 32)
            | (sent_step & 0xFFFFFFFF))


class _NoopSpan:
    """Shared do-nothing context manager — the disabled-mode fast path."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str,
                 args: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        self._tracer._emit({"ph": "X", "name": self._name, "ts": self._t0,
                            "dur": t1 - self._t0, "tid": _tid(),
                            "args": self._args or {}})
        return False


def _tid() -> int:
    return threading.get_ident()


class Tracer:
    """Ring-buffered event recorder for one process (one trace track)."""

    def __init__(self, capacity: int = 1 << 17, rank: int = 0,
                 process_name: Optional[str] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.rank = int(rank)
        self.process_name = process_name or f"rank {rank}"
        self._events: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.emitted = 0
        self.anchors: Dict[str, float] = {}

    # -- recording --------------------------------------------------------

    def _emit(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            self._events.append(ev)
            self.emitted += 1

    def span(self, name: str,
             args: Optional[Dict[str, Any]] = None) -> _Span:
        return _Span(self, name, args)

    def complete(self, name: str, start: float, **args) -> None:
        """Retroactively emit a span that began at ``start`` (a ``now()``
        reading) and ends now — for conditional instrumentation, e.g. a
        socket drain span emitted only when bytes actually arrived."""
        t1 = time.perf_counter()
        self._emit({"ph": "X", "name": name, "ts": start, "dur": t1 - start,
                    "tid": _tid(), "args": args})

    def instant(self, name: str, **args) -> None:
        self._emit({"ph": "i", "name": name, "ts": time.perf_counter(),
                    "tid": _tid(), "args": args})

    def counter(self, name: str, value: float, **args) -> None:
        a = {"value": float(value)}
        a.update(args)
        self._emit({"ph": "C", "name": name, "ts": time.perf_counter(),
                    "tid": _tid(), "args": a})

    def flow_start(self, fid: int, name: str = "frame") -> None:
        self._emit({"ph": "s", "name": name, "id": int(fid),
                    "ts": time.perf_counter(), "tid": _tid(), "args": {}})

    def flow_end(self, fid: int, name: str = "frame") -> None:
        self._emit({"ph": "f", "name": name, "id": int(fid),
                    "ts": time.perf_counter(), "tid": _tid(), "args": {}})

    def set_anchor(self, key: str, ts: Optional[float] = None) -> float:
        """Record a named clock anchor (default: now) — the rendezvous
        handshake timestamps the cross-process merge aligns clocks with."""
        t = time.perf_counter() if ts is None else float(ts)
        self.anchors[key] = t
        return t

    # -- reading ----------------------------------------------------------

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    @property
    def dropped(self) -> int:
        return self.emitted - len(self._events)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            kept = len(self._events)
        return {"emitted": float(self.emitted),
                "kept": float(kept),
                "dropped": float(self.emitted - kept),
                "capacity": float(self.capacity)}

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.emitted = 0


# -- module-level hooks (the instrumented code calls these) ------------------

_tracer: Optional[Tracer] = None


def enable(capacity: int = 1 << 17, rank: int = 0,
           process_name: Optional[str] = None) -> Tracer:
    """Install (and return) a fresh process-global tracer."""
    global _tracer
    _tracer = Tracer(capacity=capacity, rank=rank,
                     process_name=process_name)
    return _tracer


def disable() -> None:
    """Back to no-op mode (the default)."""
    global _tracer
    _tracer = None


def get() -> Optional[Tracer]:
    return _tracer


def active() -> bool:
    return _tracer is not None


def now() -> float:
    """A timestamp for a later ``complete``; 0.0 when tracing is off so
    callers can skip their own bookkeeping on the no-op path."""
    return time.perf_counter() if _tracer is not None else 0.0


def span(name: str, **args):
    t = _tracer
    if t is None:
        return _NOOP
    return t.span(name, args)


def complete(name: str, start: float, **args) -> None:
    t = _tracer
    if t is not None:
        t.complete(name, start, **args)


def instant(name: str, **args) -> None:
    t = _tracer
    if t is not None:
        t.instant(name, **args)


def counter(name: str, value: float, **args) -> None:
    t = _tracer
    if t is not None:
        t.counter(name, value, **args)


def flow_start(fid: int, name: str = "frame") -> None:
    t = _tracer
    if t is not None:
        t.flow_start(fid, name)


def flow_end(fid: int, name: str = "frame") -> None:
    t = _tracer
    if t is not None:
        t.flow_end(fid, name)


def set_anchor(key: str, ts: Optional[float] = None) -> Optional[float]:
    t = _tracer
    if t is not None:
        return t.set_anchor(key, ts)
    return None
