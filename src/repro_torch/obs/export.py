"""Chrome trace-event export and cross-process merge (a copy of
``repro/obs/export.py``: standard library only).

One `Tracer` produces one *track*: its events become Chrome trace-event
JSON (the ``traceEvents`` array format that Perfetto and chrome://tracing
load directly) with ``pid`` = rank and one ``tid`` per Python thread.
Timestamps are converted from `time.perf_counter()` seconds to the
format's microseconds.

Cross-process merge
  Each gossip child writes its own ``trace_r{rank}.json``; its clock is
  `perf_counter` with a per-process arbitrary epoch, so raw timestamps
  from different ranks are NOT comparable. The launcher's port rendezvous
  is a natural two-way handshake, and both ends record its timestamps as
  tracer *anchors*:

      child:  c_send (just before reporting its port)
              c_recv (just after receiving the port broadcast)
      parent: p_recv (when it received that child's port)
              p_send (when it broadcast the map)

  The classic symmetric-delay estimate maps a child clock onto the
  parent's:

      offset_r = ((p_recv - c_send) + (p_send - c_recv)) / 2

  i.e. parent_time ≈ child_time + offset_r, exact when the pipe delay is
  symmetric. On one host the residual error is well under the span
  durations being attributed (milliseconds); see docs/observability.md
  for the caveats.

`merge_traces` shifts every rank onto the parent clock, re-bases the
whole timeline at zero, and emits one Perfetto-loadable file whose
per-edge flow events (same ``flow_id`` computed on both ends) draw
send→delivery arrows across rank tracks.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from repro_torch.obs.tracer import Tracer

TRACE_VERSION = 1

_US = 1e6  # perf_counter seconds -> trace microseconds


def to_chrome_events(events: List[Dict[str, Any]], pid: int,
                     offset_s: float = 0.0,
                     base_s: float = 0.0) -> List[Dict[str, Any]]:
    """Tracer events -> Chrome trace-event dicts on track ``pid``.

    ``offset_s`` shifts this track onto the reference clock (cross-process
    alignment); ``base_s`` re-bases the merged timeline at zero (applied
    after the offset)."""
    out: List[Dict[str, Any]] = []
    tids: Dict[int, int] = {}
    for ev in events:
        tid = tids.setdefault(ev.get("tid", 0), len(tids))
        ts = (ev["ts"] + offset_s - base_s) * _US
        ch: Dict[str, Any] = {"ph": ev["ph"], "name": ev["name"],
                              "pid": pid, "tid": tid,
                              "ts": ts, "args": ev.get("args", {})}
        if ev["ph"] == "X":
            ch["dur"] = ev["dur"] * _US
        elif ev["ph"] == "i":
            ch["s"] = "t"  # thread-scoped instant
        elif ev["ph"] in ("s", "f"):
            ch["cat"] = "flow"
            ch["id"] = ev["id"]
            if ev["ph"] == "f":
                ch["bp"] = "e"  # bind to the enclosing slice
        out.append(ch)
    return out


def _track_metadata(pid: int, name: str) -> List[Dict[str, Any]]:
    return [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
             "args": {"name": name}},
            {"ph": "M", "name": "process_sort_index", "pid": pid, "tid": 0,
             "args": {"sort_index": pid}}]


def write_trace(path: str, tracer: Tracer,
                meta: Optional[Dict[str, Any]] = None) -> str:
    """One process's trace as a self-contained Chrome trace JSON.

    The file is directly Perfetto-loadable on its own AND carries enough
    metadata (``otherData``: rank, clock anchors, drop stats) for
    `merge_traces` to fold it into a fleet timeline later."""
    events = tracer.events()
    chrome = _track_metadata(tracer.rank, tracer.process_name)
    chrome += to_chrome_events(events, pid=tracer.rank)
    payload = {
        "traceEvents": chrome,
        "displayTimeUnit": "ms",
        "otherData": {
            "version": TRACE_VERSION,
            "rank": tracer.rank,
            "process_name": tracer.process_name,
            "anchors": dict(tracer.anchors),
            "stats": tracer.stats(),
            "meta": meta or {},
        },
    }
    with open(path, "w") as f:
        json.dump(payload, f)
        f.write("\n")
    return path


def load_trace(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def rendezvous_offset(anchors: Dict[str, float],
                      parent_recv: float, parent_send: float) -> float:
    """child-clock -> parent-clock offset from the rendezvous handshake
    (see module docstring). Falls back to 0.0 — a same-clock merge — when
    a child never recorded its anchors (tracing enabled mid-run)."""
    c_send = anchors.get("rendezvous_send")
    c_recv = anchors.get("rendezvous_recv")
    if c_send is None or c_recv is None:
        return 0.0
    return ((parent_recv - c_send) + (parent_send - c_recv)) / 2.0


def merge_traces(rank_paths: Dict[int, str], out_path: str,
                 parent_anchors: Optional[Dict[int, Any]] = None,
                 meta: Optional[Dict[str, Any]] = None) -> str:
    """Merge per-rank trace files into one fleet timeline.

    ``rank_paths`` maps rank -> its ``write_trace`` output.
    ``parent_anchors`` maps rank -> (parent_recv, parent_send) rendezvous
    timestamps on the parent clock; None merges without alignment (only
    correct when every file shares one process clock — the in-process
    case)."""
    loaded: Dict[int, Dict[str, Any]] = {}
    offsets: Dict[int, float] = {}
    for rank, path in sorted(rank_paths.items()):
        data = load_trace(path)
        loaded[rank] = data
        if parent_anchors is not None and rank in parent_anchors:
            p_recv, p_send = parent_anchors[rank]
            offsets[rank] = rendezvous_offset(
                data["otherData"].get("anchors", {}),
                float(p_recv), float(p_send))
        else:
            offsets[rank] = 0.0

    # re-base the merged timeline so the earliest aligned event is t=0
    base_us = None
    for rank, data in loaded.items():
        for ev in data["traceEvents"]:
            if ev["ph"] == "M":
                continue
            ts = ev["ts"] + offsets[rank] * _US
            if base_us is None or ts < base_us:
                base_us = ts
    base_us = base_us or 0.0

    merged: List[Dict[str, Any]] = []
    other: Dict[str, Any] = {"version": TRACE_VERSION, "merged": True,
                             "ranks": sorted(loaded),
                             "offsets_s": {str(r): offsets[r]
                                           for r in sorted(offsets)},
                             "per_rank": {}, "meta": meta or {}}
    for rank, data in sorted(loaded.items()):
        shift_us = offsets[rank] * _US - base_us
        for ev in data["traceEvents"]:
            ev = dict(ev)
            ev["pid"] = rank
            if ev["ph"] != "M":
                ev["ts"] = ev["ts"] + shift_us
            merged.append(ev)
        od = data.get("otherData", {})
        other["per_rank"][str(rank)] = {
            "anchors": od.get("anchors", {}),
            "stats": od.get("stats", {}),
            "meta": od.get("meta", {}),
        }
    with open(out_path, "w") as f:
        json.dump({"traceEvents": merged, "displayTimeUnit": "ms",
                   "otherData": other}, f)
        f.write("\n")
    return out_path
