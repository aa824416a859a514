"""Training launcher (port of ``repro/launch/train.py``).

Two modes:
  * ``--mode supervised`` — train one architecture on synthetic token data
    (and, for llama-3.2-vision and whisper, synthetic patch embeddings or
    audio frames), one `launch.steps` train step a batch.
  * ``--mode mhd`` — the paper's decentralized run: K clients, private
    shards with skew s, public pool, checkpoint pools, a communication
    topology, and multi-headed distillation (core/runtime.py).

Both run on the card unless ``--device cpu`` asks for the CPU; there is no
fallback. The batches follow the reference's numpy draws (tokens first,
then the vision embeddings or the audio frames), so one ``--seed`` gives
both packages the same data. For an audio config ``--seq-len`` is the
encoder's frame count and the decoder takes the config's ``decoder_len``
tokens.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --mode mhd --clients 4 \\
      --steps 200 --skew 100 --topology complete --aux-heads 3
  PYTHONPATH=src python -m repro_torch.launch.train --mode supervised \\
      --arch whisper-large-v3 --reduced --steps 20 --device cpu
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List

import numpy as np
import torch


def supervised_batch(rng: np.random.Generator, cfg, batch_size: int,
                     seq_len: int, device) -> Dict[str, torch.Tensor]:
    """One synthetic batch in the reference's draw order: tokens (B, T);
    then, for a vision config, patch embeddings (B, P, embed_dim); for an
    audio config, fresh tokens (B, decoder_len) and frames (B, T,
    frame_dim). Embeddings are standard normal draws in float32."""
    B, T = batch_size, seq_len

    def floats(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device)

    def tokens(shape):
        return torch.from_numpy(rng.integers(
            0, cfg.vocab_size, size=shape, dtype=np.int32)).to(device)

    batch = {"tokens": tokens((B, T))}
    if cfg.vision is not None:
        batch["vision_embeds"] = floats(
            (B, cfg.vision.num_patches, cfg.vision.embed_dim))
    if cfg.audio is not None:
        batch = {"tokens": tokens((B, cfg.audio.decoder_len))}
        batch["audio_frames"] = floats((B, T, cfg.audio.frame_dim))
    return batch


def run_supervised(args) -> List[Dict[str, float]]:
    """``args.steps`` train steps of ``args.arch``; prints the reference's
    lines and returns each step's metrics as floats."""
    from repro_torch import resolve_device
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.models.zoo import build_bundle
    from repro_torch.optim.optimizers import OptimizerConfig, make_optimizer

    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    bundle = build_bundle(cfg)
    opt = make_optimizer(OptimizerConfig(
        name=args.optimizer, init_lr=args.lr, total_steps=args.steps))
    state = init_train_state(bundle, opt, seed=args.seed, device=dev)
    step_fn = make_train_step(bundle, opt)

    rng = np.random.default_rng(args.seed)
    history: List[Dict[str, float]] = []
    t0 = time.time()
    for t in range(args.steps):
        batch = supervised_batch(rng, cfg, args.batch_size, args.seq_len,
                                 dev)
        state, metrics = step_fn(state, batch)
        history.append({k: float(v) for k, v in metrics.items()})
        if t % max(args.steps // 10, 1) == 0:
            print(f"step {t}: loss {history[-1]['loss']:.4f}")
    print(f"done: {args.steps} steps in {time.time()-t0:.1f}s; "
          f"final loss {history[-1]['loss']:.4f}")
    return history


def run_mhd(args) -> Dict[str, float]:
    """The paper's decentralized run on ResNet clients; prints and returns
    the final evaluation's ``mean/`` metrics."""
    from repro_torch.core import (
        MHDConfig, DecentralizedTrainer, RunConfig,
        complete_graph, cycle_graph, islands_graph, chain_graph,
    )
    from repro_torch.core.graph import random_regular_graph_fn
    from repro_torch.data import (make_synthetic_vision, partition_dataset,
                                  PartitionConfig)
    from repro_torch.models.resnet import resnet_tiny, resnet_tiny34
    from repro_torch.models.zoo import build_bundle
    from repro_torch.optim.optimizers import OptimizerConfig, make_optimizer

    K = args.clients
    ds = make_synthetic_vision(num_labels=args.labels,
                               samples_per_label=args.samples_per_label,
                               image_size=8, noise=args.noise, seed=args.seed)
    test = make_synthetic_vision(num_labels=args.labels, samples_per_label=20,
                                 image_size=8, noise=args.noise,
                                 seed=args.seed + 999,
                                 prototype_seed=args.seed)
    pcfg = PartitionConfig(
        num_clients=K, num_labels=args.labels,
        labels_per_client=max(args.labels // K, 1) * 2,
        assignment="random", skew=args.skew, gamma_pub=0.1, seed=args.seed)
    part = partition_dataset(ds.labels, pcfg)
    arrays = {"images": ds.images, "labels": ds.labels}

    if args.topology == "random":
        graph = random_regular_graph_fn(K, degree=1, seed=args.seed,
                                        reshuffle_every=args.pool_every)
    else:
        topo = {"complete": complete_graph, "cycle": cycle_graph,
                "chain": chain_graph}.get(args.topology)
        graph = topo(K) if topo else islands_graph(K, 2)

    maker = resnet_tiny34 if args.big_clients else resnet_tiny
    bundles = [build_bundle(maker(args.labels, num_aux_heads=args.aux_heads))
               for _ in range(K)]
    opt = make_optimizer(OptimizerConfig(init_lr=args.lr,
                                         total_steps=args.steps,
                                         grad_clip_norm=1.0))
    mhd = MHDConfig(nu_emb=args.nu_emb, nu_aux=args.nu_aux,
                    num_aux_heads=args.aux_heads, delta=args.delta,
                    confidence=args.confidence,
                    pool_size=min(K, 8), pool_update_every=args.pool_every)
    trainer = DecentralizedTrainer(
        bundles, opt, mhd,
        RunConfig(steps=args.steps, batch_size=args.batch_size,
                  public_batch_size=args.batch_size,
                  eval_every=args.eval_every, seed=args.seed),
        arrays, part.client_indices, part.public_indices, graph, args.labels,
        device=args.device)
    trainer.train(eval_arrays={"images": test.images, "labels": test.labels},
                  log_every=max(args.steps // 10, 1))
    final = trainer.evaluate({"images": test.images, "labels": test.labels})
    mean = {k: v for k, v in final.items() if k.startswith("mean/")}
    print(json.dumps({k: round(v, 4) for k, v in mean.items()}, indent=2))
    return mean


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mode", choices=["supervised", "mhd"], default="mhd")
    p.add_argument("--arch", default="qwen2.5-32b")
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--optimizer", default="sgd_momentum")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu; no fallback")
    # mhd options (paper §4.1 defaults scaled to CPU)
    p.add_argument("--clients", type=int, default=4)
    p.add_argument("--labels", type=int, default=16)
    p.add_argument("--samples-per-label", type=int, default=60)
    p.add_argument("--noise", type=float, default=1.0)
    p.add_argument("--skew", type=float, default=100.0)
    p.add_argument("--topology", default="complete",
                   choices=["complete", "cycle", "islands", "chain",
                            "random"])
    p.add_argument("--confidence", default="max",
                   choices=["max", "entropy", "margin", "random"])
    p.add_argument("--aux-heads", type=int, default=3)
    p.add_argument("--delta", type=int, default=1)
    p.add_argument("--nu-emb", type=float, default=1.0)
    p.add_argument("--nu-aux", type=float, default=1.0)
    p.add_argument("--pool-every", type=int, default=20)
    p.add_argument("--eval-every", type=int, default=0)
    p.add_argument("--big-clients", action="store_true")
    args = p.parse_args(argv)
    if args.mode == "supervised":
        run_supervised(args)
    else:
        run_mhd(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
