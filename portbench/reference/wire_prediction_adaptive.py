"""Plain reference of the entropy-adaptive top-k wire
(``"exchange": "prediction_adaptive"``): what a student holds of a
teacher's published window. Imports torch alone.

Frozen from the program's published semantics as of commit
2982e0a3c166b6b3c956e35f80f9ac7deeae8935: per row the top-k logits by
value (ties to the lower class), their logsumexp, a retention plan k_t
per token that shares ``budget·N // (H·entry)`` entries by the main
head's entropy (f32 arithmetic, leftover entries to the largest
fractional quotas, clipped to [k_min, k]), values as float16; the
receiver's dense row puts the retained logits at their classes and
spreads the rest of the mass evenly over the other classes. A window
covers the ``horizon`` public batches from its publish step.

``held`` reads the program's side: the digest of a window a student's
pool holds, for the check to judge against ``digest`` of the
reference's.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

Tensor = torch.Tensor
K_MIN = 1


def retention(main: Tensor, lse: Tensor, k: int, k_min: int, heads: int,
              budget: int, entry_bytes: int) -> Tensor:
    """k_t (N,) int64 of every token of a window, from the main head's
    logits (N, C) and logsumexp (N,), in float32."""
    x = main.float() - lse.float()[:, None]
    ent = torch.clamp(-(torch.exp(x) * x).sum(-1), min=0.0)
    N = ent.shape[0]
    R = max((budget * N) // (heads * entry_bytes) - N * k_min, 0)
    if R == 0:
        return torch.full((N,), k_min, dtype=torch.int64, device=main.device)
    s = ent.sum()
    w = ent if float(s) > 0 else torch.ones_like(ent)
    sw = s if float(s) > 0 else torch.tensor(float(N), device=main.device)
    quota_f = torch.full_like(w, float(R)) * w / sw
    fl = torch.floor(quota_f)
    rem = max(R - int(fl.sum().item()), 0)
    order = torch.argsort(-(quota_f - fl), stable=True)
    bonus = torch.zeros(N, dtype=torch.int64, device=main.device)
    bonus[order[:rem]] = 1
    return torch.clamp(k_min + fl.long() + bonus, k_min, k)


def wire_window(heads: Tensor, k: int, k_min: int, budget: int,
                val_bytes: int, idx_bytes: int) -> Tensor:
    """What a receiver holds of a published window: heads (W, H, N, C)
    logits (already rounded to bfloat16) -> dense (W, H, N, C) in their
    dtype."""
    W, H, N, C = heads.shape
    vals, order = torch.sort(heads, dim=-1, descending=True, stable=True)
    vals, order = vals[..., :k], order[..., :k]
    lse = torch.logsumexp(heads, dim=-1)  # (W, H, N)
    kt = retention(heads[:, 0].reshape(W * N, C),
                   lse[:, 0].reshape(W * N), k, k_min, H, budget,
                   val_bytes + idx_bytes).reshape(W, 1, N, 1)
    if val_bytes == 2:
        vals = vals.to(torch.float16).to(heads.dtype)
    kept = torch.arange(k, device=heads.device)[None, None, None, :] < kt
    retained = torch.where(kept, torch.exp(vals - lse[..., None]),
                           0.0).sum(-1)
    tail = torch.clamp(1.0 - retained, min=1e-30)
    fill = lse + torch.log(tail / torch.clamp(C - kt[..., 0], min=1))
    out = fill[..., None].expand(W, H, N, C).clone()
    src = torch.where(kept, vals, fill[..., None].expand_as(vals))
    return out.scatter(-1, order, src)


def receive(outputs_at: Callable[[int], Dict[str, Tensor]], traffic: dict,
            cfg: dict) -> Dict[int, Dict[str, Tensor]]:
    """A teacher's window published at step 0 as a student holds it:
    {step: {"logits" (n, C), "aux" (m, n, C)}} for each step it covers,
    from ``outputs_at(t)``, the teacher's outputs on public batch t."""
    c = traffic["comm"]
    heads = []
    for t in range(c["horizon"]):
        out = outputs_at(t)
        heads.append(torch.cat([out["logits"][None], out["aux"]]))
    dense = wire_window(torch.stack(heads), c["topk"], K_MIN,
                        c["budget_bytes_per_token"],
                        2 if c["val_dtype"] == "float16" else 4,
                        2 if cfg["vocab_size"] <= 0xFFFF else 4)
    return {t: {"logits": dense[t, 0], "aux": dense[t, 1:]}
            for t in range(dense.shape[0])}


def _rows_digest(dense: Tensor, traffic: dict) -> Tensor:
    """A window (W, H, N, C) as its rows' k + 1 largest values, sorted, in
    float64 on the host: the retained values and the spread tail, which do
    not depend on which of two tied classes a side kept."""
    k = traffic["comm"]["topk"]
    return torch.topk(dense, k + 1, dim=-1).values.double().cpu()


def digest(frames: Dict[int, Dict[str, Tensor]], traffic: dict) -> Tensor:
    """The digest of a window the reference received."""
    return _rows_digest(torch.stack([
        torch.cat([frames[t]["logits"][None], frames[t]["aux"]])
        for t in sorted(frames)]), traffic)


def held(entry, traffic: dict) -> Tensor:
    """The digest of the window a program's pool entry holds."""
    w = entry.params.outs
    return _rows_digest(torch.cat([w["logits"][:, None], w["aux_logits"]],
                                  1), traffic)
