"""Public token pool + LM client glue (port of ``repro/lm/pool.py``).

  * `make_text_arrays` — the deterministic public token stream: per-domain
    bigram languages (`data.synthetic.make_synthetic_text`) with the
    transition tables pinned by ``table_seed``, so a test split shares the
    train split's domain languages. The arrays ({"tokens", "labels"}) drop
    into `PublicPool` / `BatchIterator` unchanged.
  * `lm_client_bundle` — wraps an LM `ModelBundle` so its ``apply``
    returns the positions-as-samples MHD layout
    (`core.lm_adapter.lm_mhd_outputs`). The `DecentralizedTrainer` needs
    no LM branch: it sees a bundle whose outputs have B' = positions rows,
    each carrying its own CE target ("labels") and source sequence
    ("sample_rows").
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.core.lm_adapter import lm_mhd_outputs
from repro_torch.data.synthetic import make_synthetic_text
from repro_torch.models.zoo import ModelBundle


def make_text_arrays(num_domains: int, sequences_per_domain: int,
                     seq_len: int, vocab_size: int,
                     temperature: float = 0.5, seed: int = 0,
                     table_seed: Optional[int] = None
                     ) -> Dict[str, np.ndarray]:
    """Array dict for the public/private text pools: {"tokens" (N, T) i32,
    "labels" (N,) i32 domain ids}."""
    ds = make_synthetic_text(
        num_domains=num_domains,
        sequences_per_domain=sequences_per_domain, seq_len=seq_len,
        vocab_size=vocab_size, temperature=temperature, seed=seed,
        table_seed=table_seed)
    return {"tokens": ds.tokens, "labels": ds.labels}


def lm_client_bundle(bundle: ModelBundle, max_positions: int = 0,
                     position_seed: Optional[int] = None) -> ModelBundle:
    """An LM bundle whose ``apply`` speaks the MHD client protocol:
    {"embedding" (B', D), "logits" (B', V), "aux_logits" (m, B', V),
    "labels" (B',), "sample_rows" (B',), "aux_loss"}. Every client and
    teacher of a fleet must share ``max_positions``/``position_seed`` so
    their position rows align."""
    def apply(params, batch):
        out = lm_mhd_outputs(bundle, params, batch,
                             max_positions=max_positions,
                             position_seed=position_seed)
        return {k: v for k, v in out.items() if v is not None}

    return dataclasses.replace(bundle, apply=apply)


def lm_wire_tokens(batch_sequences: int, seq_len: int,
                   max_positions: int = 0) -> int:
    """Tokens per public batch on the wire: B·(T−1) next-token positions,
    truncated by ``max_positions`` — the N that bytes/token budgets and
    the smoke's ledger assertions are denominated in."""
    n = batch_sequences * (seq_len - 1)
    return min(n, max_positions) if max_positions else n
