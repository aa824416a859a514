"""Quickstart on the PyTorch/CUDA port: 3 decentralized clients learn from
each other with Multi-Headed Distillation — no data, weights or gradients
exchanged — on one NVIDIA GPU.

    python examples/port_quickstart.py

The spec is `examples/quickstart.py`'s, run through `repro_torch.exp`
instead of `repro.exp`; like every entry point of the port it runs on the
card and exits with an error when there is none. Expected output: each
client's MAIN head is good on its private classes; the AUX heads approach
the ensemble's knowledge of ALL classes (β_sh well above what any isolated
client can reach).
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.exp import (  # noqa: E402
    AlgorithmSpec,
    DataSpec,
    Experiment,
    ExperimentSpec,
    OptimizerSpec,
    PartitionSpec,
    TrainSpec,
)

HEADS = ("main", "aux1", "aux2")


def build_spec() -> ExperimentSpec:
    K, labels, steps = 3, 12, 400
    return ExperimentSpec(
        name="quickstart",
        algorithm=AlgorithmSpec("mhd", {
            "nu_emb": 1.0, "nu_aux": 1.0, "delta": 1,
            "pool_size": K, "pool_update_every": 10}),
        # a labeled corpus, split into a public unlabeled pool + skewed shards
        data=DataSpec(num_labels=labels, samples_per_label=200, noise=2.0,
                      seed=0),
        partition=PartitionSpec(labels_per_client=4, assignment="random",
                                skew=100.0, gamma_pub=0.1),
        clients=ExperimentSpec.uniform_fleet(K, aux_heads=2),
        optimizer=OptimizerSpec(init_lr=0.05, grad_clip_norm=1.0),
        train=TrainSpec(steps=steps, batch_size=32, public_batch_size=32,
                        seed=0))


def beta_table(ev) -> str:
    return "\n".join(
        f"  {head:5s}  private β_priv={ev[f'mean/{head}/beta_priv']:.3f}"
        f"  shared β_sh={ev[f'mean/{head}/beta_sh']:.3f}" for head in HEADS)


def main():
    def on_step(t, metrics):
        if t % 100 == 0:
            print(f"step {t:4d}  client-0 loss {metrics['c0/loss']:.3f}")

    ev = Experiment(build_spec()).run(on_step=on_step).metrics

    print("\nfinal accuracies (ensemble means):")
    print(beta_table(ev))
    print("\nThe aux heads' β_sh should clearly beat the main head's — that "
          "is the knowledge the clients\nabsorbed from each other without "
          "sharing data or weights.")


if __name__ == "__main__":
    main()
