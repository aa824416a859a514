"""Shared per-label evaluator (β_priv / β_sh, paper §4.2.1), port of
``repro/core/evaluation.py``: per-label accuracy of each head on a uniform
test set, reduced to ``c{i}/{head}/beta_*`` and the ensemble means
``mean/{head}/beta_*``."""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch


def label_histogram(labels: np.ndarray, indices: np.ndarray,
                    num_labels: int) -> np.ndarray:
    """A client's normalized private-label distribution (for β_priv)."""
    hist = np.bincount(labels[indices], minlength=num_labels).astype(np.float64)
    return hist / max(hist.sum(), 1.0)


@torch.no_grad()
def per_label_head_accuracy(
    apply_fn: Callable[[Any, Dict[str, Any]], Dict[str, Any]],
    params: Any,
    arrays: Dict[str, np.ndarray],
    num_labels: int,
    num_aux_heads: int = 0,
    batch_size: int = 256,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-label accuracy of the main head and each aux head, computed on
    the device that holds ``params`` (a flat path-keyed dict of tensors).

    Returns ``(per_label, present)``: per_label has shape
    ``(num_aux_heads + 1, num_labels)`` (row 0 = main head), present is the
    bool mask of labels that occur in the test set.
    """
    device = next(iter(params.values())).device
    labels = arrays["labels"]
    correct = np.zeros((num_aux_heads + 1, num_labels))
    count = np.zeros(num_labels)
    for s in range(0, labels.shape[0], batch_size):
        batch = {k: torch.from_numpy(np.ascontiguousarray(v[s:s + batch_size]))
                 .to(device) for k, v in arrays.items() if k != "labels"}
        o = apply_fn(params, batch)
        lab = labels[s:s + batch_size]
        heads = [o["logits"]] + [o["aux_logits"][h]
                                 for h in range(num_aux_heads)]
        preds = torch.stack([h.argmax(-1) for h in heads]).cpu().numpy()
        np.add.at(count, lab, 1)
        for hi, p in enumerate(preds):
            np.add.at(correct[hi], lab[p == lab], 1)
    per_label = correct / np.maximum(count, 1)[None]
    return per_label, count > 0


def head_names(num_aux_heads: int) -> List[str]:
    return ["main"] + [f"aux{h + 1}" for h in range(num_aux_heads)]


def fleet_beta_metrics(
    per_client: Sequence[Tuple[int, np.ndarray, np.ndarray, np.ndarray]],
    num_aux_heads: int = 0,
) -> Dict[str, float]:
    """Reduce per-client per-label accuracies to the unified namespace.

    ``per_client`` entries are ``(client_id, per_label, present,
    label_hist)`` as produced by `per_label_head_accuracy` +
    `label_histogram`.
    """
    out: Dict[str, float] = {}
    names = head_names(num_aux_heads)
    ids = []
    for cid, per_label, present, hist in per_client:
        ids.append(cid)
        w_priv = hist * present
        w_priv = w_priv / max(w_priv.sum(), 1e-9)
        for hi, nm in enumerate(names):
            out[f"c{cid}/{nm}/beta_sh"] = float(per_label[hi][present].mean())
            out[f"c{cid}/{nm}/beta_priv"] = float(
                (per_label[hi] * w_priv).sum())
    for nm in names:
        for metric in ("beta_sh", "beta_priv"):
            vals = [out[f"c{cid}/{nm}/{metric}"] for cid in ids]
            out[f"mean/{nm}/{metric}"] = float(np.mean(vals))
    return out
