"""Serve→distill feedback: production traffic becomes the public stream
(port of ``repro/serve/feedback.py``).

The paper's public pool D_* is "any unlabeled data all clients can see".
A serving front is exactly such a source: every query it answers is an
unlabeled sample every client observed being served. `TrafficLog`
accumulates the served inputs; `attach_traffic` swaps a live trainer's
`PublicPool` for one backed by that log — after which the *existing*
machinery does the rest: clients publish prediction windows on traffic
batches through the metered wire codecs, pull each other's windows, and
distill. Serving is the data pipeline; production load keeps improving
the fleet.

The swap follows the trainer's own ``restore()`` discipline: windows
published against the old pool are invalid under the new sample stream
(`_decode_window` checks sample ids against ``trainer.public``), so
pool entries and pending pulls are cleared and the pools reseeded at the
attach step. ``run_feedback`` runs it: attach, step N times,
report per-step distill activity and the wire bytes the feedback
traffic cost.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.data.pipeline import PublicPool


class TrafficLog:
    """Served inputs, in arrival order — the feedback corpus."""

    def __init__(self):
        self._images: List[np.ndarray] = []

    def log(self, image: np.ndarray) -> None:
        self._images.append(np.asarray(image))

    def __len__(self) -> int:
        return len(self._images)

    def arrays(self) -> Dict[str, np.ndarray]:
        if not self._images:
            raise ValueError("traffic log is empty; nothing was served")
        return {"images": np.stack(self._images)}


def attach_traffic(trainer, traffic: TrafficLog, step: int) -> PublicPool:
    """Make ``traffic`` the trainer's public distillation stream.

    Mirrors ``DecentralizedTrainer.restore``: the old pool's windows and
    pending pulls are dropped (their sample ids no longer verify), then
    pools are reseeded at ``step`` — publishing fresh windows scored on
    traffic batches over the metered wire."""
    arrays = traffic.arrays()
    pool = PublicPool(arrays, np.arange(len(traffic)),
                      trainer.public.batch_size, seed=trainer.public.seed)
    trainer.public = pool
    for c in trainer.clients:
        c.pool.entries.clear()
    if trainer.exchange != "params":
        trainer._pending = {c.client_id: {} for c in trainer.clients}
    trainer._seed_pools(step=step)
    return pool


def run_feedback(trainer, traffic: TrafficLog, start_step: int,
                 steps: int) -> List[Dict[str, float]]:
    """Attach served traffic and distill ``steps`` more steps from it.
    Returns the per-step metric dicts (``c{i}/distill_active`` says who
    actually distilled from production load)."""
    if steps < 1:
        raise ValueError("run_feedback needs steps >= 1")
    attach_traffic(trainer, traffic, step=start_step)
    return [trainer.step(start_step + k) for k in range(steps)]


def feedback_summary(step_metrics: List[Dict[str, float]],
                     num_clients: int,
                     wire_bytes: Optional[int] = None) -> Dict[str, float]:
    """Fold per-step feedback metrics into the serve report: how many
    client-steps distilled from served traffic, and what it cost on the
    wire."""
    distilled = sum(m.get(f"c{i}/distill_active", 0.0)
                    for m in step_metrics for i in range(num_clients))
    out = {"steps": float(len(step_metrics)),
           "distill_steps": float(distilled)}
    if wire_bytes is not None:
        out["wire_bytes"] = float(wire_bytes)
    return out
