"""Adapter applying MHD to language-model clients (port of
``repro/core/lm_adapter.py``).

For an LM client the MHD "sample" is a token position on the public text
pool: the prediction is the next-token distribution, the embedding the
final hidden state at that position. `lm_mhd_outputs` reshapes an LM
bundle's outputs into the (B', C) / (m, B', C) layout `core.mhd` expects,
with B' = batch · (T−1) next-token positions, optionally cut to a seeded
subset.

The subset is the reference's ``jax.random.permutation(PRNGKey(seed),
B·(T−1))[:max_positions]``: a fleet's clients and teachers align rows by
it, so a port run must keep the same positions as the JAX package does.
`jax_permutation` computes it with numpy alone — threefry2x32 under
``jax_threefry_partitionable=True`` (the default since jax 0.5) and
jax.random's sort-based shuffle.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional

import numpy as np
import torch

# ---------------------------------------------------------------------------
# jax.random.permutation, in numpy
# ---------------------------------------------------------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 block cipher (20 rounds), elementwise over the
    uint32 counter pairs (x0, x1) under the uint32 key pair."""
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


def _prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off (JAX's default):
    the seed's low 32 bits, behind a zero high word."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def _split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split`` (fold-like, partitionable threefry)."""
    b0, b1 = threefry2x32(key, np.zeros(num, np.uint32),
                          np.arange(num, dtype=np.uint32))
    return np.stack([b0, b1], axis=1)


def _random_bits32(key: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.bits(key, (n,), uint32)`` (partitionable threefry)."""
    b0, b1 = threefry2x32(key, np.zeros(n, np.uint32),
                          np.arange(n, dtype=np.uint32))
    return b0 ^ b1


@functools.lru_cache(maxsize=64)
def _permutation_cached(seed: int, n: int) -> np.ndarray:
    key = _prng_key(seed)
    x = np.arange(n, dtype=np.int32)
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(2 ** 32 - 1)))
    for _ in range(rounds):
        key, sub = _split(key)
        sort_keys = _random_bits32(sub, n)
        x = x[np.argsort(sort_keys, kind="stable")]
    x.setflags(write=False)
    return x


def jax_permutation(seed: int, n: int) -> np.ndarray:
    """``jax.random.permutation(jax.random.PRNGKey(seed), n)`` as int32:
    ceil(3·ln n / ln(2³²−1)) rounds of a stable sort by fresh 32-bit
    keys."""
    return _permutation_cached(int(seed), int(n))


# ---------------------------------------------------------------------------
# the adapter
# ---------------------------------------------------------------------------

def lm_mhd_outputs(bundle, params, batch: Dict[str, Any],
                   max_positions: int = 0,
                   position_seed: Optional[int] = None) -> Dict[str, Any]:
    """Run an LM and flatten to MHD client outputs.

    Returns {"embedding": (B', D), "logits": (B', V) bf16,
             "aux_logits": (m, B', V) bf16, "labels": (B',),
             "sample_rows": (B',), "aux_loss"} where labels are the next
    tokens (the private CE target) and sample_rows maps each position
    back to its source sequence (per-domain eval aggregation). The logits
    are cast to bf16 as in the reference, so the distillation terms run on
    bf16 rows.

    A DeepSeek bundle (``cfg.mtp``) runs without its MTP branch, which no
    output here reads; its leaves get zero gradients, as in the
    reference.

    ``max_positions`` bounds B'. With ``position_seed=None`` the kept
    positions are the batch-head prefix; with a seed they are the
    reference's fixed random subset (`jax_permutation`), identical for
    every client and teacher sharing the seed.

    Under tensor parallelism, where the heads leave their logits as
    blocks of the vocabulary (`models.transformer.vocab_shards`), the
    rows come out whole through one all-to-all
    (`common.sharding.vocab_to_rows`): each 'model' rank holds the same
    block of the B' rows of every output (`common.sharding.row_block`:
    its embeddings, labels and sample rows taken alike), so the kernels
    that score them run unchanged on fewer rows. A mean over the rows is
    then the sum over 'model' of each block's mean times its share of
    B'.
    """
    skip_mtp = {"mtp": False} if getattr(bundle.config, "mtp", False) else {}
    out = bundle.apply(params, batch, **skip_mtp)
    tokens = batch["tokens"]
    B, T = tokens.shape
    Tm1 = T - 1
    aux = out["aux_heads"]
    if max_positions and B * Tm1 > max_positions:
        # gather the kept positions straight from the (B, T, ·) outputs:
        # the same values as flattening first, without the full copies
        if position_seed is None:
            keep = torch.arange(max_positions, device=tokens.device)
        else:
            keep = torch.from_numpy(
                jax_permutation(position_seed, B * Tm1)[:max_positions]
                .astype(np.int64)).to(tokens.device)
        b, t = keep // Tm1, keep % Tm1
        emb = out["hidden"][b, t]
        lg = out["logits"][b, t].to(torch.bfloat16)
        aux_flat = None if aux is None else aux[:, b, t].to(torch.bfloat16)
        lab = tokens[b, t + 1]
        rows = b.to(torch.int32)
    else:
        D, V = out["hidden"].shape[-1], out["logits"].shape[-1]
        emb = out["hidden"][:, :-1].reshape(B * Tm1, D)
        lg = out["logits"][:, :-1].to(torch.bfloat16).reshape(B * Tm1, V)
        aux_flat = None if aux is None else aux[:, :, :-1].to(
            torch.bfloat16).reshape(aux.shape[0], B * Tm1, V)
        lab = tokens[:, 1:].reshape(B * Tm1)
        rows = torch.arange(B, dtype=torch.int32,
                            device=tokens.device).repeat_interleave(Tm1)
    if lg.shape[-1] < bundle.config.vocab_size:
        from repro_torch.common import sharding as SH

        part = SH.active_partition()
        lg = SH.vocab_to_rows(lg, part)
        if aux_flat is not None:
            aux_flat = SH.vocab_to_rows(aux_flat.transpose(0, 1),
                                        part).transpose(0, 1)
        blk = SH.row_block(lab.shape[0], part)
        emb = SH.tp_enter(emb, part)[blk]
        lab, rows = lab[blk], rows[blk]
    return {"embedding": emb, "logits": lg, "aux_logits": aux_flat,
            "labels": lab, "sample_rows": rows,
            "aux_loss": out["aux_loss"]}

