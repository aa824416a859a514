"""The program's client for traffic with ``"task": "lm"``: the model
bundle wrapped as a language-model MHD client (``repro_torch.lm.
lm_client_bundle``), its outputs kept at ``max_public_positions``
next-token positions drawn from ``position_seed``."""
from __future__ import annotations


def bundle(base, traffic: dict):
    from repro_torch import lm

    b = traffic["batch"]
    return lm.lm_client_bundle(base, b["max_public_positions"],
                               b["position_seed"])
