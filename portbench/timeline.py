"""Reading the traced round: torch.profiler's device timeline (kernels,
copies and fills on the card), the program's launch counters, the shapes
its kernel wrappers were called with, and the program's host spans
(`repro_torch.obs.tracer`), all in the host's ``perf_counter`` seconds.

The arithmetic (`merge`, `busy`, `gaps`, `label`) is plain Python over
(start, end) pairs, so the tests hold it on synthetic timelines."""
from __future__ import annotations

import re
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]
MARK = "portbench.round"


def merge(intervals: Sequence[Interval]) -> List[Interval]:
    """The union of intervals, as sorted disjoint intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals: Sequence[Interval], lo: float, hi: float
         ) -> List[Interval]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


def busy(intervals: Sequence[Interval], lo: float, hi: float) -> float:
    """Seconds of [lo, hi] in which some interval is open."""
    return sum(b - a for a, b in merge(clip(intervals, lo, hi)))


def gaps(intervals: Sequence[Interval], lo: float, hi: float
         ) -> List[Interval]:
    """The idle stretches of [lo, hi], longest first."""
    out, t = [], lo
    for a, b in merge(clip(intervals, lo, hi)):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return sorted(out, key=lambda g: g[0] - g[1])


def label(gap: Interval, spans: Sequence[Tuple[str, float, float]]) -> str:
    """The innermost host span open at the gap's midpoint, or "host"."""
    mid = 0.5 * (gap[0] + gap[1])
    open_ = [(e - s, n) for n, s, e in spans if s <= mid <= e]
    return min(open_)[1] if open_ else "host"


def host_spans(events: Sequence[dict]) -> List[Tuple[str, float, float]]:
    """(name, start, end) of the program tracer's complete spans."""
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("ph") == "X"]


def _start_ns(ev) -> int:
    f = getattr(ev, "start_ns", None)
    return int(f()) if f is not None else int(ev.start_us() * 1000)


def _dur_ns(ev) -> int:
    f = getattr(ev, "duration_ns", None)
    return int(f()) if f is not None else int(ev.duration_us() * 1000)


class ShapeLog:
    """Wraps the program's kernel entry points in ``ops`` while open and
    logs the shape each call reports through its cost module's
    ``shape_of``, with whether it will have a backward."""

    def __init__(self, ops_module, costs: Dict[str, object]):
        self.ops, self.costs = ops_module, costs
        self.calls: Dict[str, List[Tuple[dict, bool]]] = {k: [] for k in costs}
        self._orig: Dict[str, Callable] = {}

    def __enter__(self):
        import torch

        for name, mod in self.costs.items():
            orig = getattr(self.ops, mod.ENTRY)
            self._orig[name] = orig

            def wrapped(*args, _orig=orig, _name=name, _mod=mod, **kw):
                train = torch.is_grad_enabled() and any(
                    getattr(a, "requires_grad", False) for a in args)
                self.calls[_name].append((_mod.shape_of(*args, **kw), train))
                return _orig(*args, **kw)

            setattr(self.ops, mod.ENTRY, wrapped)
        return self

    def __exit__(self, *exc):
        for name, orig in self._orig.items():
            setattr(self.ops, self.costs[name].ENTRY, orig)
        return False


def profile_round(run_round: Callable[[], None], ops_module,
                  costs: Dict[str, object], tracer_module) -> dict:
    """Run one round under torch.profiler, the program's tracer and a
    `ShapeLog`. Returns the round's wall seconds, the device intervals and
    kernel times, the host spans, the launch-counter deltas and the
    logged shapes, all on the ``perf_counter`` clock."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    ops_module.reset_launch_counts()
    tr = tracer_module.enable()
    with ShapeLog(ops_module, costs) as shapes:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with record_function(MARK):
                run_round()
                torch.cuda.synchronize()
            t1 = time.perf_counter()
    tracer_module.disable()
    launches = ops_module.launch_counts()
    events = prof.profiler.kineto_results.events()
    mark = [e for e in events if e.name() == MARK
            and e.device_type() == DeviceType.CPU]
    # the profiler's clock to perf_counter's: the mark opened at t0
    offset = (_start_ns(mark[0]) * 1e-9 - t0) if mark else 0.0
    device: List[Tuple[str, float, float]] = []
    for e in events:
        # the mark's own span on the card's track is an annotation, no work
        user = getattr(e, "is_user_annotation", None)
        if e.device_type() == DeviceType.CUDA and e.name() != MARK and \
                not (user is not None and user()):
            s = _start_ns(e) * 1e-9 - offset
            device.append((e.name(), s, s + _dur_ns(e) * 1e-9))
    return {"t0": t0, "t1": t1, "device": device,
            "spans": host_spans(tr.events()), "launches": launches,
            "shapes": shapes.calls, "aligned": bool(mark)}


def kernel_times(device: Sequence[Tuple[str, float, float]]
                 ) -> Dict[str, float]:
    """Seconds on the card by operation name."""
    out: Dict[str, float] = {}
    for name, s, e in device:
        out[name] = out.get(name, 0.0) + (e - s)
    return out


def breakdown(prof: dict, top: int = 10) -> dict:
    lo, hi = prof["t0"], prof["t1"]
    times = kernel_times(prof["device"])
    ops_ = sorted(times.items(), key=lambda kv: -kv[1])[:top]
    idle = gaps([(s, e) for _, s, e in prof["device"]], lo, hi)[:top]
    return {"device_ops": [[n[:120], t] for n, t in ops_],
            "idle_gaps": [[label(g, prof["spans"]), g[1] - g[0]]
                          for g in idle]}


def device_busy(prof: dict) -> float:
    return busy([(s, e) for _, s, e in prof["device"]], prof["t0"],
                prof["t1"])


def family_seconds(prof: dict, prefix: str) -> Optional[float]:
    """Device seconds of the kernels whose names start with ``prefix``
    (after any return type or namespace the demangled name carries)."""
    pat = re.compile(r"(^|[^A-Za-z0-9_])" + re.escape(prefix))
    t = sum(e - s for n, s, e in prof["device"] if pat.search(n))
    return t if t > 0 else None
