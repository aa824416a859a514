"""Plain reference of a language-model client's outputs and objective
(paper §3.2, Eqs. 1, 4, 5), for traffic with ``"task": "lm"``. Imports
numpy and torch alone; the model is the configuration's own reference
module.

Frozen from the program's published semantics as of commit
2982e0a3c166b6b3c956e35f80f9ac7deeae8935:

  * positions: a batch's B' sample rows are the next-token positions
    ``permutation(position_seed, B·(T−1))[:max_positions]`` of the batch,
    the permutation being ``jax.random.permutation`` (threefry2x32,
    partitionable, sort-based shuffle), written out in numpy;
  * logits enter every loss term rounded to bfloat16;
  * the loss: CE on the private positions, plus ν_aux Σ_k of the
    confidence-gated ("max") distillation of aux head k towards the more
    confident of the teacher's and its own level k−1 head, per position;
    a step without a teacher is the CE alone.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor

# ---------------------------------------------------------------------------
# positions: jax.random.permutation(PRNGKey(seed), n), in numpy
# ---------------------------------------------------------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def _threefry(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def permutation(seed: int, n: int) -> np.ndarray:
    key = np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)
    x = np.arange(n, dtype=np.int32)
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(2 ** 32 - 1)))
    for _ in range(rounds):
        b0, b1 = _threefry(key, np.zeros(2, np.uint32),
                           np.arange(2, dtype=np.uint32))
        key, sub = np.array([b0[0], b1[0]]), np.array([b0[1], b1[1]])
        r0, r1 = _threefry(sub, np.zeros(n, np.uint32),
                           np.arange(n, dtype=np.uint32))
        x = x[np.argsort(r0 ^ r1, kind="stable")]
    return x


def positions(seed: int, batch: int, seq_len: int, keep: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """(row, position) of the kept next-token positions of a batch."""
    n = batch * (seq_len - 1)
    idx = permutation(seed, n)[:keep] if keep and n > keep else np.arange(n)
    return idx // (seq_len - 1), idx % (seq_len - 1)


def bf16(x: Tensor) -> Tensor:
    """x rounded to bfloat16 and held in its own dtype again."""
    return x.to(torch.bfloat16).to(x.dtype)


# ---------------------------------------------------------------------------
# a client's outputs and objective
# ---------------------------------------------------------------------------

def _kept(tokens: Tensor, traffic: dict) -> Tuple[Tensor, Tensor]:
    b = traffic["batch"]
    rows, pos = positions(b["position_seed"], tokens.shape[0],
                          tokens.shape[1], b["max_public_positions"])
    return (torch.from_numpy(rows).to(tokens.device),
            torch.from_numpy(pos).to(tokens.device))


def outputs(model, params: Dict[str, Tensor], cfg: dict,
            batch: Dict[str, np.ndarray], traffic: dict, device
            ) -> Dict[str, Tensor]:
    """{"logits" (n, C), "aux" (m, n, C)} at the batch's kept positions,
    rounded to bfloat16 in the params' dtype."""
    tokens = torch.from_numpy(batch["tokens"]).to(device)
    rows, pos = _kept(tokens, traffic)
    main, aux = model.heads(params, model.hidden(params, cfg,
                                                 tokens)[rows, pos])
    return {"logits": bf16(main), "aux": bf16(aux)}


def labels(batch: Dict[str, np.ndarray], traffic: dict, device) -> Tensor:
    """The next token at each kept position (n,)."""
    tokens = torch.from_numpy(batch["tokens"]).to(device)
    rows, pos = _kept(tokens, traffic)
    return tokens[rows, pos + 1].long()


def objective(out_priv: Dict[str, Tensor], labels: Tensor,
              out_pub: Optional[Dict[str, Tensor]],
              teacher: Optional[Dict[str, Tensor]], traffic: dict) -> Tensor:
    """Eq. 1 with ν_emb = 0, Δ = 1 and the "max" confidence. ``teacher``:
    the dense {"logits" (n, C), "aux" (m, n, C)} of its window at this
    step, or None (the supervised step)."""
    m_cfg = traffic["mhd"]
    if (m_cfg["nu_emb"], m_cfg["delta"], m_cfg["confidence"]) != \
            (0.0, 1, "max"):
        raise ValueError("task_lm follows nu_emb 0, delta 1 and the max "
                         "confidence alone")
    ce = F.cross_entropy(out_priv["logits"], labels)
    if teacher is None:
        return ce
    total = torch.zeros((), dtype=ce.dtype, device=ce.device)
    m = out_pub["aux"].shape[0]
    for k in range(1, m + 1):
        student = out_pub["aux"][k - 1]
        if k == 1:
            cand = [teacher["logits"], out_pub["logits"]]
        else:
            cand = [teacher["aux"][k - 2], out_pub["aux"][k - 2]]
        cand = torch.stack([c.detach() for c in cand])  # (2, n, C)
        p = torch.softmax(cand, dim=-1)
        winner = p.amax(-1).argmax(0)  # (n,)
        target = p.gather(0, winner[None, :, None].expand(
            1, *p.shape[1:]))[0]
        per = -(target * F.log_softmax(student, dim=-1)).sum(-1)
        total = total + per.mean()
    return ce + m_cfg["nu_aux"] * total
