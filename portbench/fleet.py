"""The system under test: the port's decentralized MHD trainer, built from
a configuration and a traffic mix as ``chip_smoke.py``'s LM path builds it
(the traffic's client bundle, ``make_optimizer``, ``MHDConfig``,
``RunConfig``, the traffic's graph and, for a prediction exchange, a
``LoopbackTransport``), with the benchmark's own data and weights handed
in.

The benchmark imports the program here, and, for the traced round, its
kernel dispatch and tracer (``harness.run``)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from portbench import spec
from repro_torch.comm import CommConfig, LoopbackTransport
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import DecentralizedTrainer, MHDConfig, RunConfig, graph
from repro_torch.models import build_bundle
from repro_torch.models.layers import MetaDraw
from repro_torch.optim import OptimizerConfig, make_optimizer

# the configuration file's numbers and the program's ModelConfig fields
# they must equal
_CHECKED = {"d_model": "d_model", "n_layer": "num_layers",
            "vocab_size": "vocab_size", "num_aux_heads": "num_aux_heads"}
_CHECKED_MAMBA = {"d_state": "d_state", "d_conv": "d_conv",
                  "expand": "expand", "headdim": "head_dim",
                  "chunk_size": "chunk_size"}


def model_config(config: dict):
    """The program's ModelConfig for a configuration file, checked against
    the file's numbers: the file says what runs."""
    port = config["port"]
    base = (get_reduced if port.get("preset") == "reduced"
            else get_config)(port["arch"])
    cfg = dataclasses.replace(base, **port.get("overrides", {}))
    got = {k: getattr(cfg, f) for k, f in _CHECKED.items()}
    if cfg.mamba is not None:
        got.update({k: getattr(cfg.mamba, f)
                    for k, f in _CHECKED_MAMBA.items()})
    wrong = {k: (v, config[k]) for k, v in got.items()
             if k in config and v != config[k]}
    if wrong:
        raise ValueError(f"the program's {port['arch']} is not the "
                         f"configuration file's: {wrong}")
    return cfg


def param_shapes(cfg) -> Dict[str, tuple]:
    """The program's parameter names and shapes, drawn on meta."""
    return {k: tuple(v.shape) for k, v in
            build_bundle(cfg).init(MetaDraw().manual_seed(0)).items()}


def build_trainer(cfg, traffic: dict, data,
                  weights: List[Dict[str, torch.Tensor]],
                  device: torch.device) -> DecentralizedTrainer:
    """The trainer over the benchmark's ``data`` (arrays, public indices,
    private indices), each client's init handing it ``weights[i]``; the
    client bundle, graph, exchange and optimizer are the traffic's."""
    arrays, public, private = data
    b, m = traffic["batch"], traffic["mhd"]
    client = spec.part("clients", traffic["task"])
    bundles = [dataclasses.replace(client.bundle(build_bundle(cfg), traffic),
                                   init=lambda gen, _w=w: _w)
               for w in weights]
    exchange = traffic["exchange"]
    opt = traffic["optimizer"]
    return DecentralizedTrainer(
        bundles, make_optimizer(OptimizerConfig(**opt)),
        MHDConfig(nu_emb=m["nu_emb"], nu_aux=m["nu_aux"],
                  num_aux_heads=cfg.num_aux_heads, delta=m["delta"],
                  confidence=m["confidence"], pool_size=m["pool_size"],
                  pool_update_every=m["pool_update_every"]),
        RunConfig(steps=opt["total_steps"], batch_size=b["private"],
                  public_batch_size=b["public"], eval_every=0,
                  eval_batch_size=b["private"],
                  seed=traffic["schedule_seed"]),
        arrays, private, public,
        getattr(graph, f"{traffic['graph']}_graph")(traffic["clients"]),
        int(arrays["labels"].max()) + 1, exchange=exchange,
        comm=CommConfig(**traffic["comm"]) if "comm" in traffic else None,
        transport=None if exchange == "params" else LoopbackTransport(),
        device=device)


class Recorder:
    """The program's own feed over the checked steps, read where it takes
    it: each client's private batch and sampled teachers and each step's
    public batch; which teachers each student's pool holds after the seed
    round, and the wire's digest (``held``) of each window it holds.
    Installed on the instances; ``close`` takes it off."""

    def __init__(self, trainer: DecentralizedTrainer, wire, traffic: dict):
        self.trainer = trainer
        self.pools = [[e.client_id for e in c.pool.entries]
                      for c in trainer.clients]
        self.windows = {}
        for c in trainer.clients:
            for e in c.pool.entries:
                d = wire.held(e, traffic)
                if d is not None:
                    self.windows[(c.client_id, e.client_id)] = d
        self.private: List[List[Dict[str, np.ndarray]]] = [
            [] for _ in trainer.clients]
        self.teacher: List[List[List[int]]] = [[] for _ in trainer.clients]
        self.public: Dict[int, Dict[str, np.ndarray]] = {}
        for c in trainer.clients:
            c.private_iter.next = self._wrap_next(c)
            c.pool.sample = self._wrap_sample(c)
        trainer.public.sample = self._wrap_public(trainer.public)

    def _wrap_next(self, c):
        orig = type(c.private_iter).next.__get__(c.private_iter)

        def nxt():
            batch = orig()
            self.private[c.client_id].append(
                {k: v.copy() for k, v in batch.items()})
            return batch

        return nxt

    def _wrap_sample(self, c):
        orig = type(c.pool).sample.__get__(c.pool)

        def sample(delta):
            entries = orig(delta)
            self.teacher[c.client_id].append([e.client_id for e in entries])
            return entries

        return sample

    def _wrap_public(self, pool):
        orig = type(pool).sample.__get__(pool)

        def sample(step):
            batch = orig(step)
            self.public.setdefault(step, {k: v.copy()
                                          for k, v in batch.items()})
            return batch

        return sample

    def close(self) -> None:
        for c in self.trainer.clients:
            del c.private_iter.next
            del c.pool.sample
        del self.trainer.public.sample
        self.trainer = None
