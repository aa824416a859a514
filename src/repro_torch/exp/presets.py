"""Named experiment presets — a copy of ``repro/exp/presets.py``: the same
ten specs, byte for byte in ``to_json()``. (In the reference they are
spec-file starting points for `scripts/run_experiment.py --preset
<name>` and the smoke tier.)

Presets are factories (specs are frozen; a factory per call keeps them
trivially safe to mutate via ``dataclasses.replace``).
"""
from __future__ import annotations

from typing import Callable, List

from repro_torch.common.registry import Registry
from repro_torch.exp.spec import (
    AlgorithmSpec,
    ChurnEventSpec,
    ChurnSpec,
    ClientSpec,
    DataSpec,
    ExperimentSpec,
    OptimizerSpec,
    PartitionSpec,
    ScheduleSpec,
    ServeSpec,
    TopologySpec,
    TrainSpec,
    TransportSpec,
    WireSpec,
)

PRESETS: Registry[Callable[[], ExperimentSpec]] = Registry(
    "experiment preset")


def get_preset(name: str) -> ExperimentSpec:
    return PRESETS.get(name)().validate()


def preset_names() -> List[str]:
    return PRESETS.names()


@PRESETS.register("quick")
def _quick() -> ExperimentSpec:
    """The benchmark QUICK scale: 4 MHD clients, complete graph, sync."""
    return ExperimentSpec(
        name="mhd_quick",
        algorithm=AlgorithmSpec("mhd", {
            "nu_emb": 1.0, "nu_aux": 1.0, "delta": 1,
            "pool_size": 4, "pool_update_every": 10}),
        data=DataSpec(num_labels=16, samples_per_label=200),
        partition=PartitionSpec(labels_per_client=4, skew=100.0,
                                gamma_pub=0.1),
        clients=ExperimentSpec.uniform_fleet(4, aux_heads=3),
        optimizer=OptimizerSpec(init_lr=0.05, grad_clip_norm=1.0),
        train=TrainSpec(steps=600, batch_size=32, public_batch_size=32))


@PRESETS.register("gossip")
def _gossip() -> ExperimentSpec:
    """The comm_gossip example: async heterogeneous-rate lossy ring with
    top-k prediction exchange (client 3 is a 4× straggler)."""
    s_p, straggler = 10, 4
    return ExperimentSpec(
        name="gossip_ring",
        algorithm=AlgorithmSpec("mhd", {
            "nu_emb": 1.0, "nu_aux": 1.0, "delta": 1,
            "pool_size": 2, "pool_update_every": s_p}),
        data=DataSpec(num_labels=12, samples_per_label=200),
        partition=PartitionSpec(labels_per_client=3, skew=100.0,
                                gamma_pub=0.1),
        clients=ExperimentSpec.uniform_fleet(4, aux_heads=2),
        topology=TopologySpec("cycle"),
        schedule=ScheduleSpec(mode="async", rates=(1, 1, 1, straggler)),
        transport=TransportSpec(kind="simulated", latency=1,
                                bandwidth=64 * 1024, drop_prob=0.10,
                                seed=7, client_rates={3: straggler}),
        wire=WireSpec(exchange="prediction_topk", topk=5,
                      val_dtype="float16", emb_encoding="int8",
                      horizon=s_p * straggler),
        optimizer=OptimizerSpec(init_lr=0.05, grad_clip_norm=1.0),
        train=TrainSpec(steps=200, batch_size=32, public_batch_size=32,
                        max_staleness=3 * s_p))


@PRESETS.register("gossip_socket")
def _gossip_socket() -> ExperimentSpec:
    """A 4-client prediction-exchange ring over real TCP sockets.

    In-process (`Experiment.run()`), one `SocketTransport` hosts all four
    clients over localhost TCP. The same spec drives the multi-process
    runner (`scripts/run_gossip_procs.py`): one OS process per client,
    each stepping only its own client — heterogeneous speeds are then
    real wall-clock differences. The generous horizon / staleness bound
    tolerate inter-process clock drift (a peer mid-jit-compile)."""
    s_p = 5
    return ExperimentSpec(
        name="gossip_socket_ring",
        algorithm=AlgorithmSpec("mhd", {
            "nu_emb": 1.0, "nu_aux": 1.0, "delta": 1,
            "pool_size": 2, "pool_update_every": s_p}),
        data=DataSpec(num_labels=12, samples_per_label=60),
        partition=PartitionSpec(labels_per_client=3, skew=100.0,
                                gamma_pub=0.1),
        clients=ExperimentSpec.uniform_fleet(4, aux_heads=2),
        topology=TopologySpec("cycle"),
        transport=TransportSpec(kind="socket"),
        wire=WireSpec(exchange="prediction_topk", topk=5,
                      val_dtype="float16", emb_encoding="int8",
                      horizon=4 * s_p),
        optimizer=OptimizerSpec(init_lr=0.05, grad_clip_norm=1.0),
        train=TrainSpec(steps=40, batch_size=16, public_batch_size=16,
                        max_staleness=4 * s_p))


@PRESETS.register("lm_hetero")
def _lm_hetero() -> ExperimentSpec:
    """The heterogeneous-architecture LM distillation fleet (repro.lm):
    an SSM, a dense transformer and a small MoE co-train on per-domain
    bigram text, exchanging next-token predictions over TCP on the
    entropy-adaptive wire — k varies per token under a bytes/token
    budget, and the index streams cross the wire XOR-delta'd and
    bit-packed. Embeddings stay local (``nu_emb=0``): the budget story
    is about the prediction streams, not the ξ lane. The same spec
    drives `Experiment.run()` in-process and the multi-process runner
    (``scripts/run_gossip_procs.py --lm-smoke``)."""
    s_p = 5
    return ExperimentSpec(
        name="lm_hetero",
        algorithm=AlgorithmSpec("mhd", {
            "nu_emb": 0.0, "nu_aux": 0.5, "delta": 1,
            "pool_size": 2, "pool_update_every": s_p}),
        data=DataSpec(kind="synthetic_text", num_labels=6,
                      samples_per_label=30, test_samples_per_label=8,
                      vocab_size=64, seq_len=12, max_positions=64,
                      position_seed=17),
        partition=PartitionSpec(labels_per_client=2, skew=100.0,
                                gamma_pub=0.2),
        clients=(ClientSpec(arch="lm_ssm", aux_heads=2, width=128),
                 ClientSpec(arch="lm_transformer", aux_heads=2, width=128),
                 ClientSpec(arch="lm_moe", aux_heads=2, width=128)),
        topology=TopologySpec("complete"),
        transport=TransportSpec(kind="socket"),
        wire=WireSpec(exchange="prediction_adaptive", topk=8,
                      val_dtype="float16", emb_encoding="none",
                      horizon=4 * s_p, budget_bytes_per_token=24,
                      compression="delta"),
        # AdamW, not the paper's SGD: the reduced LM shapes barely move
        # under SGD at these step counts (the vision presets' optimizer
        # stays paper-faithful; this is the "provided for the assigned
        # LLM architectures" path of repro.optim)
        optimizer=OptimizerSpec(name="adamw", init_lr=1e-2,
                                warmup_steps=10, grad_clip_norm=1.0),
        train=TrainSpec(steps=30, batch_size=8, public_batch_size=8,
                        eval_batch_size=8, max_staleness=4 * s_p))


@PRESETS.register("churn_ring")
def _churn_ring() -> ExperimentSpec:
    """An elastic 5-client prediction-exchange ring (repro.fleet): client
    4 joins late, client 1 crashes and restarts fresh, and the ring
    rewires to 2-hop reach mid-run — the churn-axis counterpart of the
    topology sweeps. Snapshot-based restarts need a snapshot_dir; this
    preset uses a fresh restart so it runs out of the box."""
    s_p, k = 5, 5
    two_hop = tuple(tuple(sorted(((i + 1) % k, (i + 2) % k)))
                    for i in range(k))
    return ExperimentSpec(
        name="churn_ring",
        algorithm=AlgorithmSpec("mhd", {
            "nu_emb": 1.0, "nu_aux": 1.0, "delta": 1,
            "pool_size": 2, "pool_update_every": s_p}),
        data=DataSpec(num_labels=12, samples_per_label=100),
        partition=PartitionSpec(labels_per_client=3, skew=100.0,
                                gamma_pub=0.1),
        clients=ExperimentSpec.uniform_fleet(k, aux_heads=2),
        topology=TopologySpec("cycle"),
        wire=WireSpec(exchange="prediction_topk", topk=5,
                      val_dtype="float16", emb_encoding="int8",
                      horizon=3 * s_p),
        optimizer=OptimizerSpec(init_lr=0.05, grad_clip_norm=1.0),
        train=TrainSpec(steps=120, batch_size=16, public_batch_size=16,
                        max_staleness=3 * s_p),
        churn=ChurnSpec(events=(
            ChurnEventSpec(kind="join", step=20, client=4),
            ChurnEventSpec(kind="kill", step=40, client=1),
            ChurnEventSpec(kind="restart", step=70, client=1,
                           from_snapshot=False),
            ChurnEventSpec(kind="rewire", step=90, edges=two_hop),
        )))


@PRESETS.register("serve_loop")
def _serve_loop() -> ExperimentSpec:
    """The full serve→distill loop (`repro_torch.serve`): train a
    4-client MHD fleet on the prediction wire, snapshot it, serve a mixed
    classify/teacher/generate stream against the snapshot, then distill
    two more steps from the served traffic. Consumed by
    ``launch/serve.py --preset serve_loop`` (``Experiment.run()`` runs
    only the training phase)."""
    s_p = 5
    return ExperimentSpec(
        name="serve_loop",
        algorithm=AlgorithmSpec("mhd", {
            "nu_emb": 1.0, "nu_aux": 1.0, "delta": 1,
            "pool_size": 2, "pool_update_every": s_p}),
        data=DataSpec(num_labels=12, samples_per_label=60),
        partition=PartitionSpec(labels_per_client=3, skew=100.0,
                                gamma_pub=0.1),
        clients=ExperimentSpec.uniform_fleet(4, aux_heads=2),
        wire=WireSpec(exchange="prediction_topk", topk=5,
                      val_dtype="float16", emb_encoding="int8",
                      horizon=2 * s_p),
        optimizer=OptimizerSpec(init_lr=0.05, grad_clip_norm=1.0),
        train=TrainSpec(steps=30, batch_size=16, public_batch_size=16),
        serve=ServeSpec(requests=24, router="label_affinity", num_slots=4,
                        max_new_tokens=12, engine_arch="minitron-4b",
                        cache_windows=4, feedback_steps=2))


@PRESETS.register("fedmd_quick")
def _fedmd_quick() -> ExperimentSpec:
    """FedMD at the QUICK scale, heterogeneous two-arch fleet (Table 2)."""
    return ExperimentSpec(
        name="fedmd_quick",
        algorithm=AlgorithmSpec("fedmd", {"digest_weight": 1.0}),
        data=DataSpec(num_labels=16, samples_per_label=200),
        partition=PartitionSpec(labels_per_client=4, skew=100.0),
        clients=tuple(ClientSpec(arch=("resnet_tiny34" if i % 2
                                       else "resnet_tiny"))
                      for i in range(4)),
        optimizer=OptimizerSpec(init_lr=0.05, grad_clip_norm=1.0),
        train=TrainSpec(steps=600, batch_size=32, public_batch_size=32))


@PRESETS.register("fedavg_quick")
def _fedavg_quick() -> ExperimentSpec:
    """FedAvg at the QUICK scale (Table 1's FA row)."""
    return ExperimentSpec(
        name="fedavg_quick",
        algorithm=AlgorithmSpec("fedavg", {"average_every": 20}),
        data=DataSpec(num_labels=16, samples_per_label=200),
        partition=PartitionSpec(labels_per_client=4, skew=100.0),
        clients=ExperimentSpec.uniform_fleet(4),
        optimizer=OptimizerSpec(init_lr=0.05, grad_clip_norm=1.0),
        train=TrainSpec(steps=600, batch_size=32))


@PRESETS.register("supervised_quick")
def _supervised_quick() -> ExperimentSpec:
    """Pooled-data supervised upper bound at the QUICK scale."""
    return ExperimentSpec(
        name="supervised_quick",
        algorithm=AlgorithmSpec("supervised", {"scope": "pooled"}),
        data=DataSpec(num_labels=16, samples_per_label=200),
        partition=PartitionSpec(labels_per_client=4, skew=100.0),
        clients=ExperimentSpec.uniform_fleet(4),
        optimizer=OptimizerSpec(init_lr=0.05, grad_clip_norm=1.0),
        train=TrainSpec(steps=600, batch_size=32))


@PRESETS.register("separate_quick")
def _separate_quick() -> ExperimentSpec:
    """The 'Separate' isolated-clients baseline at the QUICK scale."""
    return ExperimentSpec(
        name="separate_quick",
        algorithm=AlgorithmSpec("supervised", {"scope": "separate"}),
        data=DataSpec(num_labels=16, samples_per_label=200),
        partition=PartitionSpec(labels_per_client=4, skew=100.0),
        clients=ExperimentSpec.uniform_fleet(4),
        optimizer=OptimizerSpec(init_lr=0.05, grad_clip_norm=1.0),
        train=TrainSpec(steps=600, batch_size=32))
