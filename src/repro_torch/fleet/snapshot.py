"""Versioned full-fleet snapshots: everything a process needs to resume
a decentralized run bit for bit (port of ``repro/fleet/snapshot.py``).

A parameter checkpoint (`checkpoint/io`) is not enough to resume a fleet:
the run's determinism also lives in the shared pull rng, each client's
pool rng and pool contents (decoded prediction windows), the private
streams' positions, the bus mailboxes and per-client clocks, the pending
pulls, the comm meter's books, the scheduler's clocks and cursors, and the
in-process transport's in-flight mail. `save_fleet` captures all of it;
`restore_fleet` rebuilds it into a freshly constructed trainer, so that
stepping on is bitwise the run that never stopped
(tests/test_torch_fleet.py, for the MHD trainer under every schedule and
for FedMD, FedAvg and supervised). The port's trainers carry no torch rng
state from step to step — the confidence gate's generator is seeded from
the step — so the numpy states above are every rng a snapshot needs.

Layout, the reference's: one directory a snapshot step, one file a unit
of restore::

    <dir>/step_{step:010d}/
        client_{cid}.npz   # one client: params, opt state, pool (rng +
                           # entries), private stream, mailbox + clock,
                           # pending pulls
        proc_{tag}.npz     # one process: shared pull rng, meter books,
                           # scheduler clocks, transport in-flight

The process file is written last; its presence marks a complete
snapshot. Files are pickle-free: nested state is JSON with numpy arrays
and raw ``bytes`` lifted into npz members. Leaves keep the reference's
path keys and layouts (``params/...``, ``opt/<slot>/...``, ResNet
convolution kernels HWIO, `checkpoint.io.params_to_jax`), so a snapshot
written by either package restores into the other. Every file carries
``SNAPSHOT_VERSION``; a restore refuses a version it does not understand.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.io import (_load_into, flatten_with_paths,
                                       params_to_jax)

SNAPSHOT_VERSION = 1

_STEP_RE = re.compile(r"^step_(\d+)$")


# -- pickle-free structured state <-> npz ------------------------------------


def _encode(obj: Any, arrays: List[np.ndarray],
            blobs: List[bytes]) -> Any:
    """JSON-ify ``obj``, lifting arrays, tensors and bytes into side
    tables."""
    if isinstance(obj, dict):
        return {str(k): _encode(v, arrays, blobs) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_encode(v, arrays, blobs) for v in obj]
    if isinstance(obj, (bytes, bytearray)):
        blobs.append(bytes(obj))
        return {"__blob__": len(blobs) - 1}
    if isinstance(obj, torch.Tensor):
        v = obj.detach().cpu()
        obj = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    if isinstance(obj, np.ndarray):
        arrays.append(obj)
        return {"__array__": len(arrays) - 1}
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"cannot snapshot a {type(obj).__name__}: {obj!r}")


def _decode(obj: Any, arrays: Dict[str, np.ndarray],
            blobs: List[bytes]) -> Any:
    if isinstance(obj, dict):
        if set(obj) == {"__blob__"}:
            return blobs[int(obj["__blob__"])]
        if set(obj) == {"__array__"}:
            return arrays[f"a{int(obj['__array__'])}"]
        return {k: _decode(v, arrays, blobs) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode(v, arrays, blobs) for v in obj]
    return obj


def _save_state(path: str, state: Any) -> None:
    """Atomic write of one nested state structure to ``path`` (.npz)."""
    arrays: List[np.ndarray] = []
    blobs: List[bytes] = []
    meta = _encode(state, arrays, blobs)
    buf = b"".join(blobs)
    offsets = np.cumsum([0] + [len(b) for b in blobs]).astype(np.int64)
    members = {f"a{i}": a for i, a in enumerate(arrays)}
    members["meta"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    members["blob_buf"] = np.frombuffer(buf, dtype=np.uint8)
    members["blob_offsets"] = offsets
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **members)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load_state(path: str) -> Any:
    with np.load(path) as data:
        members = {k: data[k] for k in data.files}
    meta = json.loads(bytes(members["meta"].tobytes()).decode("utf-8"))
    buf = members["blob_buf"].tobytes()
    offsets = members["blob_offsets"]
    blobs = [buf[int(offsets[i]):int(offsets[i + 1])]
             for i in range(len(offsets) - 1)]
    return _decode(meta, members, blobs)


# -- trees in the reference's layout ------------------------------------------


def _flat(tree: Any) -> Dict[str, np.ndarray]:
    """A param or optimizer-state tree as the reference's path-keyed
    arrays (convolution kernels HWIO)."""
    return params_to_jax(flatten_with_paths(tree))


# -- directory layout --------------------------------------------------------


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:010d}")


def snapshot_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str,
                at_or_before: Optional[int] = None) -> Optional[int]:
    steps = [s for s in snapshot_steps(directory)
             if at_or_before is None or s <= at_or_before]
    return steps[-1] if steps else None


def _check_version(state: Dict[str, Any], path: str) -> None:
    v = state.get("version")
    if v != SNAPSHOT_VERSION:
        raise ValueError(
            f"snapshot {path} has version {v!r}; this build reads "
            f"version {SNAPSHOT_VERSION}")


# -- trainer-kind dispatch ---------------------------------------------------
#
# "decentralized" — core.runtime.DecentralizedTrainer (pools, bus, shared
# pull rng, optional scheduler clocks).
# "list" — the stepwise baselines (FedMD, FedAvg, supervised): parallel
# params, optimizer-state and iterator lists, no comm state.


def _trainer_kind(trainer: Any) -> str:
    if hasattr(trainer, "graph_fn") and hasattr(trainer, "local_ids"):
        return "decentralized"
    if hasattr(trainer, "iters"):
        return "list"
    raise TypeError(
        f"don't know how to snapshot a {type(trainer).__name__}")


def _list_slots(trainer: Any) -> Tuple[List[Any], List[Any], List[Any]]:
    params = (trainer.client_params if hasattr(trainer, "client_params")
              else trainer.params)
    return params, trainer.opt_states, trainer.iters


# -- client slices -----------------------------------------------------------


def _decentralized_client_state(trainer: Any, cid: int) -> Dict[str, Any]:
    c = trainer.clients[cid]
    if c.params is None:
        raise ValueError(f"client {cid} has no materialized state to save")
    entries = []
    for e in c.pool.entries:
        rec: Dict[str, Any] = {"client_id": int(e.client_id),
                               "step": int(e.step)}
        if trainer.exchange == "params":
            rec["params"] = _flat(e.params)
        else:
            rec["t0"] = int(e.params.t0)
            rec["outs"] = dict(e.params.outs)
        entries.append(rec)
    state: Dict[str, Any] = {
        "version": SNAPSHOT_VERSION,
        "client_id": int(cid),
        "exchange": trainer.exchange,
        "params": _flat(c.params),
        "opt": _flat(c.opt_state),
        "iter": c.private_iter.state_dict(),
        "pool": {"rng": c.pool.rng.bit_generator.state,
                 "entries": entries},
    }
    if trainer.exchange != "params":
        state["mail"] = trainer.bus.client_state(cid)
        state["pending"] = {str(src): int(rnd) for src, rnd
                            in trainer._pending[cid].items()}
    return state


def _restore_decentralized_client(trainer: Any, cid: int,
                                  state: Dict[str, Any]) -> None:
    from repro_torch.checkpoint.pool import PoolEntry
    from repro_torch.comm.bus import PredictionWindow
    from repro_torch.core.runtime import batch_to_device

    if state["exchange"] != trainer.exchange:
        raise ValueError(
            f"snapshot of client {cid} used exchange "
            f"{state['exchange']!r}; trainer runs {trainer.exchange!r}")
    c = trainer.clients[cid]
    if c.params is None:
        raise ValueError(
            f"client {cid} was not materialized in this process "
            "(init_scheme='per_client' non-local client?)")
    c.params = _load_into(state["params"], c.params)
    c.opt_state = _load_into(state["opt"], c.opt_state)
    c.private_iter.load_state_dict(state["iter"])
    c.pool.rng.bit_generator.state = state["pool"]["rng"]
    c.pool.entries = []
    for rec in state["pool"]["entries"]:
        if trainer.exchange == "params":
            target = trainer.clients[int(rec["client_id"])].params
            payload = _load_into(rec["params"], target)
        else:
            # decoded windows live on the trainer's device, as
            # `_decode_window` leaves them
            payload = PredictionWindow(int(rec["t0"]), batch_to_device(
                rec["outs"], trainer.device))
        c.pool.entries.append(
            PoolEntry(int(rec["client_id"]), payload, int(rec["step"])))
    if trainer.exchange != "params":
        trainer.bus.load_client_state(cid, state["mail"])
        trainer._pending[cid] = {int(src): int(rnd) for src, rnd
                                 in state["pending"].items()}


def _list_client_state(trainer: Any, idx: int) -> Dict[str, Any]:
    params, opts, iters = _list_slots(trainer)
    return {
        "version": SNAPSHOT_VERSION,
        "client_id": int(idx),
        "exchange": "none",
        "params": _flat(params[idx]),
        "opt": _flat(opts[idx]),
        "iter": iters[idx].state_dict(),
    }


def _restore_list_client(trainer: Any, idx: int,
                         state: Dict[str, Any]) -> None:
    params, opts, iters = _list_slots(trainer)
    params[idx] = _load_into(state["params"], params[idx])
    opts[idx] = _load_into(state["opt"], opts[idx])
    iters[idx].load_state_dict(state["iter"])


# -- public API --------------------------------------------------------------


def default_tag(trainer: Any) -> str:
    """The process tag: "all" for a whole-fleet trainer, "r3" / "r1_2"
    for a process driving a subset."""
    if _trainer_kind(trainer) != "decentralized":
        return "all"
    if trainer.local_ids == list(range(len(trainer.clients))):
        return "all"
    return "r" + "_".join(str(i) for i in trainer.local_ids)


def save_fleet(directory: str, step: int, trainer: Any,
               scheduler: Optional[Any] = None,
               process_tag: Optional[str] = None) -> str:
    """Snapshot everything this process owns at ``step``: one
    ``client_{cid}.npz`` per active local client, then the process file.
    Returns the snapshot's step directory."""
    kind = _trainer_kind(trainer)
    tag = default_tag(trainer) if process_tag is None else process_tag
    d = _step_dir(directory, step)
    os.makedirs(d, exist_ok=True)

    proc: Dict[str, Any] = {"version": SNAPSHOT_VERSION, "step": int(step),
                            "kind": kind, "tag": tag}
    if kind == "decentralized":
        saved = [c.client_id for c in trainer.local]
        for cid in saved:
            _save_state(os.path.join(d, f"client_{cid}.npz"),
                        _decentralized_client_state(trainer, cid))
        proc.update({
            "clients": saved,
            "exchange": trainer.exchange,
            "rng": trainer.rng.bit_generator.state,
            "scheduler": (None if scheduler is None
                          else scheduler.state_dict()),
            "meter": (None if trainer.meter is None
                      else trainer.meter.state_dict()),
        })
        transport_state = None
        if trainer.exchange != "params":
            transport = trainer.bus.transport
            if hasattr(transport, "quiesce"):
                # a transport with buffered frames drains them into its
                # own state first, so the state_dict below holds them
                transport.quiesce()
            transport_state = transport.state_dict()
        proc["transport"] = transport_state
    else:
        params, _, _ = _list_slots(trainer)
        saved = list(range(len(params)))
        for i in saved:
            _save_state(os.path.join(d, f"client_{i}.npz"),
                        _list_client_state(trainer, i))
        proc["clients"] = saved
    # the process file last: its presence marks a complete snapshot
    _save_state(os.path.join(d, f"proc_{tag}.npz"), proc)
    return d


def restore_fleet(directory: str, trainer: Any,
                  scheduler: Optional[Any] = None,
                  step: Optional[int] = None,
                  process_tag: Optional[str] = None) -> int:
    """Restore a freshly constructed trainer (and optional scheduler) to
    a snapshot: process state plus every client the snapshot's process
    saved. Returns the restored step."""
    kind = _trainer_kind(trainer)
    tag = default_tag(trainer) if process_tag is None else process_tag
    if step is None:
        step = _latest_with(directory, f"proc_{tag}.npz")
        if step is None:
            raise FileNotFoundError(
                f"no snapshot with proc_{tag}.npz under {directory}")
    path = os.path.join(_step_dir(directory, step), f"proc_{tag}.npz")
    proc = _load_state(path)
    _check_version(proc, path)
    if proc["kind"] != kind:
        raise ValueError(f"snapshot {path} is of a {proc['kind']} "
                         f"trainer; got a {kind} trainer")

    saved = [int(c) for c in proc["clients"]]
    if kind == "decentralized":
        trainer.rng.bit_generator.state = proc["rng"]
        if proc["scheduler"] is not None:
            if scheduler is None:
                raise ValueError(
                    "snapshot carries async scheduler clocks; pass the "
                    "scheduler to restore them")
            scheduler.load_state_dict(proc["scheduler"])
        if proc["meter"] is not None and trainer.meter is not None:
            trainer.meter.load_state_dict(proc["meter"])
        if proc["transport"] is not None and trainer.exchange != "params":
            trainer.bus.transport.load_state_dict(proc["transport"])
        for cid in saved:
            cpath = os.path.join(_step_dir(directory, step),
                                 f"client_{cid}.npz")
            state = _load_state(cpath)
            _check_version(state, cpath)
            _restore_decentralized_client(trainer, cid, state)
        # liveness at snapshot time: saved clients were alive; local
        # clients missing from the snapshot were dead
        for cid in trainer.local_ids:
            if cid in saved:
                trainer._dead.discard(cid)
            else:
                trainer._dead.add(cid)
        trainer.local = [trainer.clients[i] for i in trainer.local_ids
                         if i not in trainer._dead]
    else:
        for i in saved:
            cpath = os.path.join(_step_dir(directory, step),
                                 f"client_{i}.npz")
            state = _load_state(cpath)
            _check_version(state, cpath)
            _restore_list_client(trainer, i, state)
    return int(proc["step"])


def restore_clients(directory: str, trainer: Any, clients: Sequence[int],
                    step: Optional[int] = None) -> Dict[int, int]:
    """Restore individual clients' slices into a live trainer — the
    restart path of client churn. Each client comes from the newest
    snapshot at or before ``step`` that holds its file (a client dead at
    snapshot time has none there). Process-shared state (pull rng, meter,
    transport) belongs to the survivors and is left alone. Returns
    ``{client_id: restored_step}``."""
    out: Dict[int, int] = {}
    for cid in clients:
        cid = int(cid)
        found = None
        for s in reversed(snapshot_steps(directory)):
            if step is not None and s > step:
                continue
            path = os.path.join(_step_dir(directory, s),
                                f"client_{cid}.npz")
            if os.path.exists(path):
                found = (s, path)
                break
        if found is None:
            raise FileNotFoundError(
                f"no snapshot of client {cid} at or before step {step} "
                f"under {directory}")
        s, path = found
        state = _load_state(path)
        _check_version(state, path)
        if _trainer_kind(trainer) == "decentralized":
            _restore_decentralized_client(trainer, cid, state)
        else:
            _restore_list_client(trainer, cid, state)
        out[cid] = s
    return out


def _latest_with(directory: str, filename: str) -> Optional[int]:
    for s in reversed(snapshot_steps(directory)):
        if os.path.exists(os.path.join(_step_dir(directory, s), filename)):
            return s
    return None


def load_client_params(directory: str, cid: int, like: Any,
                       step: Optional[int] = None) -> Tuple[Any, int]:
    """One client's parameters out of a fleet snapshot, without a trainer
    (a finished run's snapshot directory is servable). ``like`` gives the
    target structure, devices and dtypes (a fresh bundle's params).
    Returns ``(params, snapshot_step)``; ``step=None`` picks the newest
    snapshot holding ``client_{cid}.npz``."""
    if step is None:
        step = _latest_with(directory, f"client_{cid}.npz")
        if step is None:
            raise FileNotFoundError(
                f"no snapshot of client {cid} under {directory}")
    path = os.path.join(_step_dir(directory, step), f"client_{cid}.npz")
    state = _load_state(path)
    _check_version(state, path)
    return _load_into(state["params"], like), int(step)
