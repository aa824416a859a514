"""`ExperimentSpec` — the declarative, JSON-serializable description of one
decentralized-learning experiment (a copy of ``repro/exp/spec.py``: the
same blocks, defaults and checks, so a spec's ``to_json()`` is
byte-identical in both packages).

A spec says *what* to run — data + partition protocol, the client fleet
(per-client architectures), the algorithm and its config, communication
topology, schedule (sync, lockstep, or out-of-order scoreboard), transport
+ wire format, optimizer, and the train/eval cadence — and
`repro_torch.exp.runner` says *how*. Every block is a frozen dataclass;
``to_json``/``from_json`` round-trip exactly (asserted in tests), so a
spec file is a complete, shareable record of an experiment and new
scenarios are spec edits, not new harnesses.

Client architectures are resolved through the ``CLIENT_ARCHS`` registry
(`common/registry.py`), which maps an arch name to a model-config factory
``(num_labels, aux_heads, width) -> config`` consumable by
`models.zoo.build_bundle`.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.common.registry import Registry
from repro_torch.models import resnet as _RN

# -- client architecture registry -------------------------------------------

CLIENT_ARCHS: Registry = Registry("client architecture")


# -- transport registry ------------------------------------------------------
#
# kind -> builder(spec) -> repro_torch.comm.Transport | None (None = the
# trainer's default in-process loopback). ``validate`` checks membership
# and calls the builder's optional ``validate_spec`` attribute (structural
# checks, no construction); the runner's `build_transport` dispatches here
# — a new transport is a registry entry, not an edit to a hard-coded kind
# list.

TRANSPORTS: Registry[Callable[["ExperimentSpec"], Any]] = Registry(
    "transport kind")


def _reject_socket_fields(spec: "ExperimentSpec") -> None:
    t = spec.transport
    if t.base_port is not None or t.host != "127.0.0.1":
        raise ValueError(
            "transport base_port/host configure the socket transport; "
            f"kind={t.kind!r} would silently ignore them")


@TRANSPORTS.register("loopback")
def _loopback_transport(spec: "ExperimentSpec") -> Any:
    return None  # DecentralizedTrainer's default LoopbackTransport


_loopback_transport.validate_spec = _reject_socket_fields


@TRANSPORTS.register("simulated")
def _simulated_transport(spec: "ExperimentSpec") -> Any:
    from repro_torch.comm import SimulatedNetwork

    t = spec.transport
    return SimulatedNetwork(latency=t.latency, bandwidth=t.bandwidth,
                            drop_prob=t.drop_prob, seed=t.seed,
                            client_rates=t.client_rates)


_simulated_transport.validate_spec = _reject_socket_fields


@TRANSPORTS.register("socket")
def _socket_transport(spec: "ExperimentSpec") -> Any:
    """One in-process instance hosting the whole fleet over real TCP —
    `Experiment.run()`'s view of ``kind="socket"``. The multi-process
    launcher (`launch/gossip.py`) builds one single-client instance per
    OS process instead, with ports rendezvoused between them."""
    from repro_torch.comm import SocketTransport

    t = spec.transport
    ports = None
    if t.base_port is not None:
        ports = {i: t.base_port + i for i in range(spec.num_clients)}
    return SocketTransport(spec.num_clients, ports=ports, host=t.host)


def _socket_validate(spec: "ExperimentSpec") -> None:
    t = spec.transport
    if t.latency or t.bandwidth or t.drop_prob or t.client_rates:
        raise ValueError(
            "transport latency/bandwidth/drop_prob/client_rates "
            "parameterize the simulated network; a socket transport "
            "is a real wire and would silently ignore them")


_socket_transport.validate_spec = _socket_validate


@CLIENT_ARCHS.register("resnet_tiny")
def _resnet_tiny(num_labels: int, aux_heads: int, width: int):
    return _RN.resnet_tiny(num_labels, num_aux_heads=aux_heads, width=width)


@CLIENT_ARCHS.register("resnet_tiny34")
def _resnet_tiny34(num_labels: int, aux_heads: int, width: int):
    return _RN.resnet_tiny34(num_labels, num_aux_heads=aux_heads, width=width)


def _register_lm(arch_name: str, zoo_name: str) -> None:
    """Reduced LM zoo configs as fleet archs. ``num_labels`` carries the
    head dimension — the shared vocab of a text fleet (the runner passes
    ``data.vocab_size`` when ``data.kind == "synthetic_text"``) — and
    ``width`` the model dim, so heterogeneous backbones (SSM, dense
    transformer, MoE) expose identical head shapes to the MHD wire."""

    @CLIENT_ARCHS.register(arch_name)
    def _factory(num_labels: int, aux_heads: int, width: int):
        from repro_torch.configs import get_reduced

        return dataclasses.replace(
            get_reduced(zoo_name), vocab_size=num_labels,
            d_model=width, num_aux_heads=aux_heads)


_register_lm("lm_ssm", "mamba2-370m")
_register_lm("lm_transformer", "gemma3-12b")
_register_lm("lm_moe", "arctic-480b")


# -- spec blocks -------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DataSpec:
    """Synthetic class-conditional dataset (DESIGN.md §7.1 CPU scale).

    The test set is drawn from the same class prototypes
    (``prototype_seed = seed``) with sample seed ``seed + 991`` — the
    convention every benchmark harness used.

    ``kind="synthetic_text"`` (per-domain bigram LMs,
    `data.synthetic.make_synthetic_text`) reuses the label fields as
    their text twins: ``num_labels`` = number of domains,
    ``samples_per_label`` = sequences per domain — β metrics then
    aggregate per domain exactly as per class. The test split pins the
    domain languages with ``table_seed = seed`` and draws samples from
    ``seed + 991``. ``vocab_size``/``seq_len`` shape the sequences;
    ``max_positions`` bounds the per-batch token positions entering MHD
    (0 = all ``batch·(seq_len−1)``) and ``position_seed`` picks them as
    a fixed random subset instead of the biased batch-head prefix
    (`core/lm_adapter.lm_mhd_outputs`)."""

    kind: str = "synthetic_vision"
    num_labels: int = 16
    samples_per_label: int = 200
    image_size: int = 8
    noise: float = 2.0
    test_samples_per_label: int = 15
    seed: int = 0
    vocab_size: int = 64  # text: shared vocab (= every client's head dim)
    seq_len: int = 16  # text: tokens per sequence
    max_positions: int = 0  # text: MHD positions per batch; 0 = all
    position_seed: Optional[int] = None  # text: None = prefix truncation


@dataclasses.dataclass(frozen=True)
class PartitionSpec:
    """Paper §3.3 protocol: public pool fraction γ_pub + skewed shards."""

    labels_per_client: int = 4
    assignment: str = "random"  # "random" | "even"
    skew: float = 100.0  # the paper's s
    gamma_pub: float = 0.1
    even_multiplicity: int = 2
    seed: Optional[int] = None  # None = DataSpec.seed


@dataclasses.dataclass(frozen=True)
class ClientSpec:
    """One fleet member. Heterogeneous fleets list different archs."""

    arch: str = "resnet_tiny"
    aux_heads: int = 0
    width: int = 8


@dataclasses.dataclass(frozen=True)
class AlgorithmSpec:
    """Which `Algorithm` adapter runs, plus its free-form config.

    ``params`` is passed to the adapter (e.g. MHD: ``nu_emb``, ``nu_aux``,
    ``delta``, ``pool_size``, ``pool_update_every``, ...; fedmd:
    ``digest_weight``; fedavg: ``average_every``; supervised: ``scope``).
    Adapters validate the keys they understand."""

    name: str = "mhd"
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """Communication graph G_t (`core/graph.py`)."""

    name: str = "complete"  # complete|cycle|chain|islands|isolated
    hops: int = 1  # cycle reach
    islands: int = 2  # islands count


@dataclasses.dataclass(frozen=True)
class ScheduleSpec:
    """Stepping model: the synchronous loop or the scoreboard runtime.

    ``mode="lockstep"`` drives the algorithm with per-client logical
    clocks in strict wall-tick order (`core/scheduler.AsyncScheduler`;
    ``"async"`` is the historical alias), ``mode="scoreboard"`` issues
    each client's LocalStep/Publish/Pull/Resolve ops the moment their
    dependencies are satisfied (`core/scheduler.ScoreboardScheduler`).
    ``train.steps`` then counts wall ticks. ``rates[i]`` is wall ticks
    per local step of client i (None = uniform 1×).

    Scoreboard-only knobs: ``runahead`` bounds how many wall ticks a
    client may advance past its slowest in-neighbor before backpressure
    stalls it (None = unbounded); ``pace_ms[i]`` is client i's minimum
    real milliseconds between local steps (None = unpaced)."""

    mode: str = "sync"  # "sync" | "lockstep" (alias "async") | "scoreboard"
    rates: Optional[Tuple[int, ...]] = None
    runahead: Optional[int] = None
    pace_ms: Optional[Tuple[float, ...]] = None


@dataclasses.dataclass(frozen=True)
class TransportSpec:
    """How published bytes move — resolved through the ``TRANSPORTS``
    registry (built-in kinds: "loopback", "simulated", "socket").

    ``latency``/``bandwidth``/``drop_prob``/``client_rates`` parameterize
    the simulated network only; a socket transport is a real wire whose
    behavior comes from the host network. ``base_port``/``host`` apply to
    sockets: ``base_port=None`` binds OS-assigned ports (in-process runs);
    an explicit base gives client i port ``base_port + i`` (the
    fixed-rendezvous option for multi-process runs)."""

    kind: str = "loopback"  # any registered TRANSPORTS kind
    latency: int = 0  # wall ticks of propagation
    bandwidth: Optional[int] = None  # bytes per wall tick; None = unlimited
    drop_prob: float = 0.0
    seed: int = 0
    client_rates: Optional[Dict[int, int]] = None  # slow uplinks (async)
    base_port: Optional[int] = None  # socket: client i listens on base+i
    host: str = "127.0.0.1"  # socket: bind/connect address


@dataclasses.dataclass(frozen=True)
class WireSpec:
    """What crosses the wire (`repro_torch.comm.wire`).

    ``exchange="params"`` is the legacy simulation shortcut (raw
    parameters, nothing metered); the prediction modes are the paper's
    §3.2 protocol. ``"prediction_adaptive"`` is the entropy-adaptive
    top-k wire (`repro_torch.lm.adaptive_wire`): k varies per token under
    ``budget_bytes_per_token`` (0 = unbounded — byte-identical to
    ``"prediction_topk"``). ``compression="delta"`` wraps whichever
    codec in the XOR-delta + bit-packed index stream
    (`repro_torch.lm.compress`); ``"none"`` is today's frames byte-for-byte."""

    exchange: str = "params"  # params|prediction_{topk,dense,adaptive}
    topk: int = 32
    val_dtype: str = "float16"
    emb_encoding: str = "int8"
    tail: str = "uniform"
    horizon: int = 0  # 0 = auto (S_P)
    budget_bytes_per_token: int = 0  # adaptive: (val,idx) bytes/token cap
    compression: str = "none"  # "none" | "delta"


@dataclasses.dataclass(frozen=True)
class ChurnEventSpec:
    """One scripted fleet event (`repro_torch.fleet.events`), in wall steps.

    ``kind``: "kill" | "restart" | "join" | "rewire". ``client`` names
    the affected client (kill/restart/join); ``from_snapshot`` picks the
    restart source (latest fleet snapshot vs fresh re-init); ``arch`` is
    documentation for joins (the fleet's ClientSpec list owns the
    architecture); ``edges`` is a full adjacency for rewires."""

    kind: str
    step: int
    client: Optional[int] = None
    from_snapshot: bool = True
    arch: Optional[str] = None
    edges: Optional[Tuple[Tuple[int, ...], ...]] = None


@dataclasses.dataclass(frozen=True)
class ChurnSpec:
    """The scripted churn timeline — empty means a static fleet (the
    pre-fleet behavior, unchanged)."""

    events: Tuple[ChurnEventSpec, ...] = ()


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """Mirror of `optim.optimizers.OptimizerConfig`; ``total_steps=None``
    follows ``train.steps``."""

    name: str = "sgd_momentum"
    init_lr: float = 0.05
    total_steps: Optional[int] = None
    warmup_steps: int = 0
    momentum: float = 0.9
    weight_decay: float = 0.0
    grad_clip_norm: Optional[float] = None
    state_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    """Loop cadence: steps (wall ticks when async), batching, eval and
    checkpoint rhythm. ``eval_every=0`` = final evaluation only.

    ``checkpoint_*`` is the plain params-only checkpoint
    (`checkpoint/io`); ``snapshot_*`` is the full *fleet* snapshot
    (`repro_torch.fleet.snapshot`: params + opt + pools + mailboxes +
    clocks + stream positions — the bitwise-resume and churn-restart
    unit).
    ``snapshot_every=0`` disables snapshotting."""

    steps: int = 600
    batch_size: int = 32
    public_batch_size: int = 32
    eval_every: int = 0
    eval_batch_size: int = 256
    max_staleness: Optional[int] = None
    seed: int = 0
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0  # 0 = final only (when checkpoint_dir is set)
    snapshot_dir: Optional[str] = None
    snapshot_every: int = 0  # fleet snapshots every N steps; 0 = never
    trace_dir: Optional[str] = None  # repro_torch.obs traces; None = off


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """The inference path (the reference's `repro.serve`; serving is not
    ported yet, ROADMAP Queue 1 item 14 — the block validates and
    round-trips as in the reference): serve the trained fleet from
    its snapshot, optionally feeding served traffic back as the public
    distillation stream.

    ``requests=0`` disables serving (the default — training specs are
    unchanged). The serve block is consumed by
    `repro.serve.run_serve_scenario` (via ``launch/serve.py --preset`` or
    `benchmarks/serve.py`), *after* training; `Experiment.run()` itself
    never serves. ``engine_arch`` names a reduced zoo LM config
    (`repro.configs.get_reduced`) for the continuous-batching decode
    engine; ``None`` serves the classify/teacher paths only.
    ``feedback_steps`` distills that many extra steps from the served
    `TrafficLog` (needs a prediction exchange — the feedback rides the
    metered wire)."""

    requests: int = 0  # mixed classify/teacher queries; 0 = disabled
    router: str = "label_affinity"  # client_id|label_affinity|round_robin
    num_slots: int = 4  # continuous-batching engine lanes
    max_new_tokens: int = 16  # decode budget per generate request
    engine_arch: Optional[str] = None  # reduced LM config name; None = off
    cache_windows: int = 8  # teacher-cache LRU capacity
    teachers: Optional[Tuple[int, ...]] = None  # None = the whole fleet
    feedback_steps: int = 0  # serve→distill steps on served traffic
    seed: int = 0  # request stream + engine params


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    name: str = "experiment"
    algorithm: AlgorithmSpec = dataclasses.field(default_factory=AlgorithmSpec)
    data: DataSpec = dataclasses.field(default_factory=DataSpec)
    partition: PartitionSpec = dataclasses.field(
        default_factory=PartitionSpec)
    clients: Tuple[ClientSpec, ...] = (ClientSpec(),) * 4
    topology: TopologySpec = dataclasses.field(default_factory=TopologySpec)
    schedule: ScheduleSpec = dataclasses.field(default_factory=ScheduleSpec)
    transport: TransportSpec = dataclasses.field(
        default_factory=TransportSpec)
    wire: WireSpec = dataclasses.field(default_factory=WireSpec)
    optimizer: OptimizerSpec = dataclasses.field(
        default_factory=OptimizerSpec)
    train: TrainSpec = dataclasses.field(default_factory=TrainSpec)
    churn: ChurnSpec = dataclasses.field(default_factory=ChurnSpec)
    serve: ServeSpec = dataclasses.field(default_factory=ServeSpec)
    # model-init rng scheme: "legacy" = the shared split chain every
    # process replays for the whole fleet (bitwise-identical to pre-fleet
    # runs, O(K²) fleet startup across K processes); "per_client" =
    # fold_in(seed, client_id), so a gossip child materializes only its
    # own clients — O(K) startup. Different stream, hence opt-in.
    init_scheme: str = "legacy"

    @property
    def num_clients(self) -> int:
        return len(self.clients)

    # -- serialization ------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentSpec":
        d = dict(d)
        sub = {
            "algorithm": AlgorithmSpec,
            "data": DataSpec,
            "partition": PartitionSpec,
            "topology": TopologySpec,
            "schedule": ScheduleSpec,
            "transport": TransportSpec,
            "wire": WireSpec,
            "optimizer": OptimizerSpec,
            "train": TrainSpec,
            "churn": ChurnSpec,
            "serve": ServeSpec,
        }
        kwargs: Dict[str, Any] = {}
        for key, val in d.items():
            if key in ("name", "init_scheme"):
                kwargs[key] = val
            elif key == "clients":
                kwargs[key] = tuple(_build(ClientSpec, c) for c in val)
            elif key in sub:
                kwargs[key] = _build(sub[key], val)
            else:
                raise ValueError(f"unknown ExperimentSpec field {key!r}")
        return cls(**kwargs)

    @classmethod
    def from_json(cls, text: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(text))

    def validate(self) -> "ExperimentSpec":
        """Cheap structural checks (registry membership is the runner's
        job — it owns the Algorithm registry)."""
        if not self.clients:
            raise ValueError("an experiment needs at least one client")
        for c in self.clients:
            if c.arch not in CLIENT_ARCHS:
                raise ValueError(
                    f"unknown client arch {c.arch!r}; "
                    f"known: {CLIENT_ARCHS.names()}")
        self._validate_schedule()
        if self.transport.kind not in TRANSPORTS:
            raise ValueError(f"unknown transport kind "
                             f"{self.transport.kind!r}; "
                             f"known: {TRANSPORTS.names()}")
        kind_check = getattr(TRANSPORTS.get(self.transport.kind),
                             "validate_spec", None)
        if kind_check is not None:
            kind_check(self)
        if self.wire.exchange == "params" and \
                self.transport.kind != "loopback":
            raise ValueError(
                "wire.exchange='params' puts nothing on a transport — a "
                f"{self.transport.kind!r} transport would silently not "
                "apply; use a prediction exchange or transport 'loopback'")
        if self.wire.exchange not in ("params", "prediction_topk",
                                      "prediction_dense",
                                      "prediction_adaptive"):
            raise ValueError(f"unknown exchange {self.wire.exchange!r}")
        if self.wire.compression not in ("none", "delta"):
            raise ValueError(
                f"unknown wire compression {self.wire.compression!r}")
        if self.wire.compression != "none" and \
                self.wire.exchange == "params":
            raise ValueError(
                "wire.compression applies to prediction frames; "
                "wire.exchange='params' has none — it would silently "
                "not apply")
        if self.wire.budget_bytes_per_token < 0:
            raise ValueError("wire.budget_bytes_per_token must be >= 0")
        if self.wire.budget_bytes_per_token and \
                self.wire.exchange != "prediction_adaptive":
            raise ValueError(
                "wire.budget_bytes_per_token is the adaptive wire's "
                f"knob; exchange {self.wire.exchange!r} would silently "
                "ignore it")
        if self.topology.name not in ("complete", "cycle", "chain",
                                      "islands", "isolated"):
            raise ValueError(f"unknown topology {self.topology.name!r}")
        if self.data.kind not in ("synthetic_vision", "synthetic_text"):
            raise ValueError(f"unknown data kind {self.data.kind!r}")
        if self.data.kind == "synthetic_text":
            if self.data.vocab_size < 2 or self.data.seq_len < 2:
                raise ValueError(
                    "synthetic_text needs vocab_size >= 2 and "
                    "seq_len >= 2 (next-token positions are T-1)")
        if self.init_scheme not in ("legacy", "per_client"):
            raise ValueError(f"unknown init_scheme {self.init_scheme!r}; "
                             "known: legacy, per_client")
        if self.init_scheme == "per_client" and \
                self.wire.exchange == "params":
            raise ValueError(
                "init_scheme='per_client' skips materializing non-local "
                "clients; the params exchange reads every client's raw "
                "params and needs init_scheme='legacy'")
        if self.train.snapshot_every and not self.train.snapshot_dir:
            raise ValueError(
                "train.snapshot_every needs train.snapshot_dir")
        self._validate_churn()
        self._validate_serve()
        return self

    def _validate_schedule(self) -> None:
        s = self.schedule
        if s.mode not in ("sync", "async", "lockstep", "scoreboard"):
            raise ValueError(f"unknown schedule mode {s.mode!r}")
        if s.rates is not None and len(s.rates) != self.num_clients:
            raise ValueError(
                f"{len(s.rates)} schedule rates for "
                f"{self.num_clients} clients")
        if s.mode == "sync":
            for knob in ("rates", "runahead", "pace_ms"):
                if getattr(s, knob) is not None:
                    raise ValueError(
                        f"schedule.{knob} only applies to the scheduler "
                        "modes; a sync run would silently ignore it")
            return
        if s.rates is not None and any(int(r) < 1 for r in s.rates):
            raise ValueError("schedule.rates must be >= 1")
        if s.runahead is not None and int(s.runahead) < 1:
            raise ValueError("schedule.runahead must be >= 1 wall tick")
        if s.pace_ms is not None:
            if len(s.pace_ms) != self.num_clients:
                raise ValueError(
                    f"{len(s.pace_ms)} schedule pace_ms for "
                    f"{self.num_clients} clients")
            if any(float(p) < 0 for p in s.pace_ms):
                raise ValueError("schedule.pace_ms must be >= 0")
        # Horizon-vs-publish-gap: a rate-r client only reaches its next
        # pool boundary every r*S_P wall ticks, so prediction mailboxes
        # must survive at least that long or a straggler's neighbors
        # read nothing between its publishes.
        if self.algorithm.name == "mhd" and \
                self.wire.exchange in ("prediction_topk",
                                       "prediction_dense",
                                       "prediction_adaptive"):
            s_p = int(self.algorithm.params.get("pool_update_every", 200))
            horizon = int(self.wire.horizon) or s_p
            max_rate = max(int(r) for r in s.rates) if s.rates else 1
            if horizon < max_rate * s_p:
                raise ValueError(
                    f"wire.horizon={horizon} is shorter than the slowest "
                    f"client's publish gap (max rate {max_rate} x "
                    f"pool_update_every {s_p} = {max_rate * s_p} wall "
                    "ticks); its mailboxes would expire before neighbors "
                    "read them — raise wire.horizon or lower the rate "
                    "skew")

    def _validate_serve(self) -> None:
        s = self.serve
        if s.requests < 0 or s.feedback_steps < 0:
            raise ValueError("serve.requests/feedback_steps must be >= 0")
        if s.router not in ("client_id", "label_affinity", "round_robin"):
            raise ValueError(f"unknown serve router {s.router!r}")
        if s.num_slots < 1 or s.max_new_tokens < 1 or s.cache_windows < 1:
            raise ValueError(
                "serve.num_slots/max_new_tokens/cache_windows must be >= 1")
        if s.teachers is not None:
            bad = [t for t in s.teachers
                   if not 0 <= int(t) < self.num_clients]
            if bad:
                raise ValueError(f"serve.teachers {bad} out of range for "
                                 f"{self.num_clients} clients")
        if s.feedback_steps > 0 and s.requests <= 0:
            raise ValueError(
                "serve.feedback_steps > 0 needs serve.requests > 0 — "
                "feedback distills from served traffic")
        if s.feedback_steps > 0 and self.wire.exchange == "params":
            raise ValueError(
                "serve→distill feedback rides the prediction wire; "
                "wire.exchange='params' has no metered wire — use a "
                "prediction exchange")

    def _validate_churn(self) -> None:
        for ev in self.churn.events:
            if ev.kind not in ("kill", "restart", "join", "rewire"):
                raise ValueError(f"unknown churn event kind {ev.kind!r}")
            if ev.step < 0:
                raise ValueError(f"churn event at negative step {ev.step}")
            if ev.kind == "rewire":
                if ev.edges is None or len(ev.edges) != self.num_clients:
                    raise ValueError(
                        f"rewire@{ev.step} needs a full adjacency "
                        f"({self.num_clients} rows)")
                continue
            if ev.client is None or not \
                    (0 <= ev.client < self.num_clients):
                raise ValueError(
                    f"churn {ev.kind}@{ev.step} needs a client id in "
                    f"[0, {self.num_clients})")
            if ev.kind == "restart" and ev.from_snapshot and \
                    not self.train.snapshot_dir:
                raise ValueError(
                    f"restart@{ev.step} from snapshot needs "
                    "train.snapshot_dir (or from_snapshot=false for a "
                    "fresh re-init)")
        if self.churn.events:
            # full timeline coherence (kill/restart alternation, rewire
            # adjacency validity): delegate to the runtime's Membership,
            # so --dry-run rejects an incoherent script before training
            from repro_torch.fleet import Membership, events_from_spec

            Membership(lambda step: [()] * self.num_clients,
                       self.num_clients, events_from_spec(self.churn))

    # -- convenience constructors ------------------------------------------

    @staticmethod
    def uniform_fleet(num_clients: int, arch: str = "resnet_tiny",
                      aux_heads: int = 0,
                      width: int = 8) -> Tuple[ClientSpec, ...]:
        return tuple(ClientSpec(arch=arch, aux_heads=aux_heads, width=width)
                     for _ in range(num_clients))


def _build(cls, d: Any) -> Any:
    """Rebuild one frozen spec block from its asdict/JSON form, restoring
    the non-JSON-native types (tuples, int dict keys)."""
    if isinstance(d, cls):
        return d
    if not isinstance(d, dict):
        raise TypeError(f"expected a dict for {cls.__name__}, got {d!r}")
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - known
    if unknown:
        raise ValueError(
            f"unknown {cls.__name__} fields {sorted(unknown)}; "
            f"known: {sorted(known)}")
    kwargs = dict(d)
    if cls is ScheduleSpec and kwargs.get("rates") is not None:
        kwargs["rates"] = tuple(int(r) for r in kwargs["rates"])
    if cls is ScheduleSpec and kwargs.get("pace_ms") is not None:
        kwargs["pace_ms"] = tuple(float(p) for p in kwargs["pace_ms"])
    if cls is TransportSpec and kwargs.get("client_rates") is not None:
        kwargs["client_rates"] = {int(k): int(v)
                                  for k, v in kwargs["client_rates"].items()}
    if cls is ChurnSpec and kwargs.get("events") is not None:
        kwargs["events"] = tuple(_build(ChurnEventSpec, e)
                                 for e in kwargs["events"])
    if cls is ChurnEventSpec and kwargs.get("edges") is not None:
        kwargs["edges"] = tuple(tuple(int(j) for j in nbrs)
                                for nbrs in kwargs["edges"])
    if cls is ServeSpec and kwargs.get("teachers") is not None:
        kwargs["teachers"] = tuple(int(t) for t in kwargs["teachers"])
    return cls(**kwargs)
