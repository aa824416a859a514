"""The port's socket transport (`repro_torch.comm.socket`) against the
transport contract, against the JAX package's socket transport on the
wire, and the `gossip_socket` preset through `Experiment.run()`.

  * The contract of tests/test_transport_contract.py, on the port's three
    transports (loopback, simulated, socket): FIFO per edge, no delivery
    before ``sent_step``, poll is a drain, an unhosted destination polls
    empty, delivered == offered after every tick; then the socket's own
    cases (a dead peer, a corrupt connection, a frame far beyond the
    kernel's buffers, the finish barrier's held-back frame, the
    drain-stall retry, quiesce + state_dict) and the meter's books.
  * Frames crossing the packages over TCP: a `repro.comm.SocketTransport`
    hosting client 0 and the port's hosting client 1 exchange frames both
    ways, byte for byte.
  * `gossip_socket` cut to 12 steps through the port's `Experiment.run()`
    against `repro.exp`'s from one initial draw, with
    tests/test_torch_runtime.py's tolerances (step metrics within 2e-4
    relative / 2e-5 absolute; distillation and gate counts equal); within
    the port, socket == loopback bitwise.
  * A mixed fleet over TCP: a JAX trainer driving client 0 on
    `repro.comm.SocketTransport` and a port trainer driving client 1 on
    the port's, against the all-reference in-process socket run.
"""
import dataclasses
import socket as pysocket
import threading
import time

import numpy as np
import pytest
import torch

import test_torch_threads

test_torch_threads.share_cores()

# the bitwise socket == loopback runs need one variant of each vectorized
# math kernel in the process (tests/test_torch_kernels.py says why)
for _op in (torch.exp, torch.log, torch.sqrt):
    _op(torch.ones(1))

import repro_torch.exp as PX  # noqa: E402
from repro_torch.comm import (CommConfig, CommMeter,  # noqa: E402
                              LoopbackTransport, PredictionBus,
                              SimulatedNetwork, SocketTransport,
                              allocate_ports)
from repro_torch.comm.socket import (FRAME_HEADER_BYTES,  # noqa: E402
                                     pack_frame)
from test_torch_exp import (assert_step_metrics_close,  # noqa: E402
                            run_both, same_initial_params)
from test_torch_scheduler import (make_trainer,  # noqa: E402
                                  params_bitwise_equal)

_DRAIN_ALL = 1 << 60  # the finish barrier's release-everything poll step


@pytest.fixture(params=["loopback", "simulated", "socket"])
def transport(request):
    """A lossless, effectively-zero-latency instance of each kind."""
    if request.param == "loopback":
        yield LoopbackTransport()
    elif request.param == "simulated":
        yield SimulatedNetwork()
    else:
        t = SocketTransport(num_clients=4)
        yield t
        t.close()


def wait_for(cond, seconds=10.0):
    deadline = time.monotonic() + seconds
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.005)


# -- the shared contract ------------------------------------------------------

def test_fifo_per_edge(transport):
    for i in range(5):
        transport.send(0, 1, f"m{i}".encode(), step=i)
    got = transport.poll(1, 10)
    assert [d.payload for d in got] == [f"m{i}".encode() for i in range(5)]
    assert [d.sent_step for d in got] == list(range(5))


def test_no_delivery_before_sent_step(transport):
    transport.send(0, 1, b"future", step=5)
    assert transport.poll(1, 3) == []
    got = transport.poll(1, 5)
    assert [d.payload for d in got] == [b"future"]
    assert got[0].recv_step == 5


def test_poll_is_a_drain(transport):
    transport.send(0, 1, b"once", step=0)
    assert len(transport.poll(1, 0)) == 1
    assert transport.poll(1, 0) == []
    assert transport.poll(1, 100) == []


def test_multiple_senders_all_arrive(transport):
    transport.send(0, 1, b"from0", step=0)
    transport.send(2, 1, b"from2", step=0)
    transport.send(3, 1, b"from3", step=1)
    got = transport.poll(1, 2)
    assert {(d.src, d.payload) for d in got} == {
        (0, b"from0"), (2, b"from2"), (3, b"from3")}


def test_unknown_destination_returns_empty(transport):
    assert transport.poll(9, 0) == []


def test_per_tick_delivered_equals_offered(transport):
    """On a lossless wire the meter's per-edge delivered book equals the
    offered book after every tick's publish + deliver (the socket in its
    in-process deterministic mode)."""
    meter = CommMeter()
    ring = [(3,), (0,), (1,), (2,)]  # adj[dst] = in-neighbors
    bus = PredictionBus(transport, ring, 4, meter=meter)
    for t in range(5):
        for src in range(4):
            bus.publish(src, f"tick{t}-from{src}".encode(), step=t)
        bus.deliver(t)
        assert meter.by_edge == meter.by_edge_delivered, f"gap at tick {t}"
    assert meter.delivered_bytes == meter.total_bytes > 0


# -- the socket's own cases ---------------------------------------------------

def test_socket_cross_instance_over_tcp():
    """Two instances (the multi-process shape, minus the processes): a
    frame bigger than one recv() chunk arrives with src and sent_step."""
    with SocketTransport(2, clients=[1], wait_inflight=False) as b, \
            SocketTransport(2, clients=[0], ports={1: b.ports[1]},
                            wait_inflight=False) as a:
        a.send(0, 1, b"x" * 70000, step=3)
        got = []

        def arrived():
            got.extend(b.poll(1, 10))
            return got

        wait_for(arrived)
        assert [(d.src, d.sent_step) for d in got] == [(0, 3)]
        assert got[0].payload == b"x" * 70000
        assert a.sent_bytes == b.recv_bytes == 70000
        assert dict(a.sent_to) == {1: 1} and b.recv_count == 1


def test_socket_set_ports_and_connect_edges():
    with SocketTransport(2, clients=[0], wait_inflight=False) as a, \
            SocketTransport(2, clients=[1], wait_inflight=False) as b:
        ports = {0: a.ports[0], 1: b.ports[1]}
        a.set_ports(ports)
        b.set_ports(ports)
        a.connect_edges([(1,), (0,)])  # ring: 0 sends to 1
        assert (0, 1) in a._out
        with pytest.raises(ValueError):
            a.set_ports({0: a.ports[0] + 1})  # hosted port can't move


def test_socket_rejects_unknown_peer_port_and_bad_clients():
    with SocketTransport(3, clients=[0], wait_inflight=False) as t:
        with pytest.raises(ValueError, match="no port known"):
            t.send(0, 2, b"?", step=0)
    with pytest.raises(ValueError, match="out of range"):
        SocketTransport(2, clients=[2])


@pytest.mark.parametrize("nbytes", [763_000, 4 << 20])
def test_socket_inprocess_big_frame_no_deadlock(nbytes):
    """One thread writes and reads the same socket pair: a frame of the
    fleet path's size at 1000 classes (about 763 KB) or far beyond the
    kernel's buffers must not deadlock the send (it drains the local
    destination while it writes)."""
    with SocketTransport(2) as t:
        big = (bytes(range(256)) * (nbytes // 256 + 1))[:nbytes]
        t.send(0, 1, big, step=0)
        got = t.poll(1, 0)
        assert len(got) == 1 and got[0].payload == big


def test_socket_drops_corrupt_connection_not_the_run():
    with SocketTransport(2, clients=[1], wait_inflight=False) as t:
        stray = pysocket.create_connection(("127.0.0.1", t.ports[1]))
        stray.sendall(b"GET / HTTP/1.1\r\n" + b"\x00" * 64)
        wait_for(lambda: t.poll(1, 0) == [] and t.corrupt_connections == 1)
        stray.close()
        with SocketTransport(2, clients=[0], ports={1: t.ports[1]},
                             wait_inflight=False) as a:
            a.send(0, 1, b"still-works", step=0)
            got = []
            wait_for(lambda: got.extend(t.poll(1, 0)) or got)
            assert [d.payload for d in got] == [b"still-works"]


def test_allocate_ports_are_distinct_and_bindable():
    ports = allocate_ports(4)
    assert len(set(ports.values())) == 4
    with SocketTransport(4, clients=[2], ports={2: ports[2]}) as t:
        assert t.ports[2] == ports[2]


def test_socket_send_to_dead_peer_is_lost_not_fatal():
    b = SocketTransport(2, clients=[1], wait_inflight=False)
    a = SocketTransport(2, clients=[0], ports={1: b.ports[1]},
                        wait_inflight=False)
    a.send(0, 1, b"first", step=0)
    b.close()
    time.sleep(0.2)  # let the peer's RST reach the sender
    for i in range(50):
        a.send(0, 1, b"x" * 4096, step=i)
    assert a.failed_sends > 0
    a.close()
    with pytest.raises(RuntimeError, match="closed"):
        a.send(0, 1, b"late", step=99)


def test_finish_barrier_strands_no_frames():
    """A frame held back by the no-delivery-before-tick rule is parsed by
    quiesce, counted on both sides, and released by the drain-all poll."""
    with SocketTransport(2, clients=[1], wait_inflight=False) as b, \
            SocketTransport(2, clients=[0], ports={1: b.ports[1]},
                            wait_inflight=False) as a:
        a.send(0, 1, b"held-back", step=99)
        deadline = time.monotonic() + 10
        while b.recv_count < 1 and time.monotonic() < deadline:
            b.quiesce(settle=0.01, timeout=1.0)
        assert dict(a.sent_to) == {1: 1}
        assert b.recv_count == 1
        assert b.poll(1, 0) == []
        assert b.undrained_bytes == 0
        got = b.poll(1, _DRAIN_ALL)
        assert [(d.src, d.payload) for d in got] == [(0, b"held-back")]


def test_drain_stall_retries_instead_of_dropping():
    """A receiver that stops reading long enough to fill the kernel
    buffers costs no frame: the sender meters ``drain_stalls`` and keeps
    the frame in flight until the receiver catches up."""
    with SocketTransport(2, clients=[1], wait_inflight=False) as b, \
            SocketTransport(2, clients=[0], ports={1: b.ports[1]},
                            wait_inflight=False, drain_timeout=0.05,
                            send_hard_timeout=30.0) as a:
        big = b"z" * (32 * 1024 * 1024)

        def drain_later():
            time.sleep(0.5)
            deadline = time.monotonic() + 20
            while b.recv_count < 1 and time.monotonic() < deadline:
                b.quiesce(settle=0.01, timeout=1.0)

        th = threading.Thread(target=drain_later)
        th.start()
        a.send(0, 1, big, step=0)
        th.join()
        assert a.failed_sends == 0
        assert a.drain_stalls >= 1
        got = b.poll(1, _DRAIN_ALL)
        assert [d.payload == big for d in got] == [True]


def test_socket_state_dict_round_trip():
    """quiesce pulls the kernel-buffered frames into the held-back queue;
    state_dict carries them and the counters into a fresh instance."""
    with SocketTransport(2, clients=[1], wait_inflight=False) as b, \
            SocketTransport(2, clients=[0], ports={1: b.ports[1]},
                            wait_inflight=False) as a:
        a.send(0, 1, b"early", step=2)
        a.send(0, 1, b"late", step=7)
        wait_for(lambda: b.quiesce(settle=0.01, timeout=0.5) == 0
                 and b.recv_count == 2)
        state = b.state_dict()
        assert state["queues"] == {1: [(0, b"early", 2), (0, b"late", 7)]}
        assert state["counters"]["recv_count"] == 2
        assert a.state_dict()["counters"]["sent_to"] == {1: 2}
    with SocketTransport(2, clients=[1], wait_inflight=False) as c:
        c.load_state_dict(state)
        assert c.recv_count == 2 and c.recv_bytes == len(b"earlylate")
        assert [d.payload for d in c.poll(1, 5)] == [b"early"]
        assert [d.payload for d in c.poll(1, 7)] == [b"late"]


def test_spec_validation_rejects_sim_knobs_on_socket():
    spec = PX.ExperimentSpec(
        transport=PX.TransportSpec(kind="socket", drop_prob=0.1),
        wire=PX.WireSpec(exchange="prediction_topk"))
    with pytest.raises(ValueError, match="real wire"):
        spec.validate()
    dataclasses.replace(spec, transport=PX.TransportSpec(
        kind="socket")).validate()
    with pytest.raises(ValueError, match="silently ignore"):
        dataclasses.replace(spec, transport=PX.TransportSpec(
            kind="simulated", base_port=9000)).validate()


def test_spec_socket_transport_hosts_the_fleet_on_base_port():
    base = allocate_ports(1)[0]
    spec = dataclasses.replace(
        PX.get_preset("gossip_socket"),
        transport=PX.TransportSpec(kind="socket", base_port=base))
    t = PX.TRANSPORTS.get("socket")(spec.validate())
    try:
        assert isinstance(t, SocketTransport) and t.wait_inflight
        assert t.local_clients == [0, 1, 2, 3]
        assert t.ports == {i: base + i for i in range(4)}
    finally:
        t.close()


# -- the meter's books --------------------------------------------------------

def test_meter_books_drops_as_offered_not_delivered():
    meter = CommMeter()
    bus = PredictionBus(SimulatedNetwork(drop_prob=1.0, seed=0),
                        [(1,), (0,)], 2, meter=meter)
    bus.publish(1, b"lost-message", step=0)
    bus.deliver(0)
    assert meter.total_bytes == len(b"lost-message")
    assert meter.delivered_bytes == 0
    assert meter.by_dst[0] == len(b"lost-message")
    assert meter.received_per_client_step(10) == {}
    assert bus.mailbox(0) == {}


def test_meter_lossless_books_agree_over_the_socket():
    meter = CommMeter()
    with SocketTransport(2) as t:
        bus = PredictionBus(t, [(1,), (0,)], 2, meter=meter)
        bus.publish(1, b"abcdef", step=0)
        bus.publish(0, b"xy", step=0)
        bus.deliver(0)
    assert meter.delivered_bytes == meter.total_bytes == 8
    assert meter.by_dst_delivered == {0: 6, 1: 2}
    assert meter.received_per_client_step(2) == {0: 3.0, 1: 1.0}


# -- frames across the packages -----------------------------------------------

def test_frames_cross_the_packages_both_ways():
    """The same 32-byte MHDF header in both packages: a frame written by
    the JAX package's transport parses in the port's and back, byte for
    byte, over TCP."""
    import repro.comm as RC
    from repro.comm.socket import FRAME_HEADER_BYTES as REF_HEADER
    from repro.comm.socket import pack_frame as ref_pack_frame

    assert FRAME_HEADER_BYTES == REF_HEADER == 32
    payload = bytes(np.random.default_rng(0).integers(
        0, 256, 200_003, dtype=np.uint8))
    assert pack_frame(3, 1, 17, payload) == ref_pack_frame(3, 1, 17, payload)
    with RC.SocketTransport(2, clients=[0], wait_inflight=False) as ref, \
            SocketTransport(2, clients=[1], wait_inflight=False) as port:
        ref.set_ports({1: port.ports[1]})
        port.set_ports({0: ref.ports[0]})
        sent = {(0, 1): [payload, b"tiny"], (1, 0): [payload[::-1], b""]}
        for step, p in enumerate(sent[(0, 1)]):
            ref.send(0, 1, p, step=step)
        for step, p in enumerate(sent[(1, 0)]):
            port.send(1, 0, p, step=step)
        got = {(0, 1): [], (1, 0): []}
        wait_for(lambda: got[(0, 1)].extend(port.poll(1, 5)) or
                 got[(1, 0)].extend(ref.poll(0, 5)) or
                 all(len(v) == 2 for v in got.values()))
        for (src, dst), ds in got.items():
            assert [(d.src, d.dst, d.sent_step) for d in ds] == \
                [(src, dst, 0), (src, dst, 1)]
            assert [d.payload for d in ds] == sent[(src, dst)]
        assert dict(ref.sent_to) == {1: 2} and port.recv_count == 2
        assert dict(port.sent_to) == {0: 2} and ref.recv_count == 2


# -- runs ---------------------------------------------------------------------

def test_socket_matches_loopback_teacher_schedule():
    """A 2-client prediction-exchange run over real TCP (in-process,
    ``wait_inflight``) equals the loopback run bitwise: step metrics,
    final params and the meter's books."""
    steps = 6
    kw = dict(steps=steps, K=2, delta=1, m=1, s_p=2,
              comm=CommConfig(topk=8, val_dtype="float32",
                              emb_encoding="float32", horizon=steps + 4))
    t_loop = make_trainer("prediction_topk", **kw)
    with SocketTransport(2) as sock:
        t_sock = make_trainer("prediction_topk", transport=sock, **kw)
        for t in range(steps):
            assert t_sock.step(t) == t_loop.step(t), t
    assert params_bitwise_equal(t_loop.clients, t_sock.clients)
    assert t_loop.meter.total_bytes == t_sock.meter.total_bytes
    assert t_sock.meter.delivered_bytes == t_sock.meter.total_bytes > 0


GOSSIP_STEPS = 12


def gossip_spec(X, steps=GOSSIP_STEPS, clients=None):
    spec = X.get_preset("gossip_socket")
    if clients is not None:
        c = spec.clients[0]
        spec = dataclasses.replace(
            spec, clients=X.ExperimentSpec.uniform_fleet(
                clients, arch=c.arch, aux_heads=c.aux_heads, width=c.width))
    return dataclasses.replace(
        spec, train=dataclasses.replace(spec.train, steps=steps))


def test_gossip_socket_matches_reference_and_loopback(monkeypatch):
    """`gossip_socket` (4 clients on a cycle, top-k 5 in f16, int8
    embeddings, S_P 5) cut to 12 steps: the port against the reference
    within the stated tolerances, and the port's socket run equal to its
    loopback run bit for bit (params, step metrics, meter books)."""
    spec = gossip_spec(PX)
    (ref_steps, ref), (port_steps, port) = run_both(monkeypatch, spec)
    assert_step_metrics_close(ref_steps, port_steps)
    assert sum(m[f"c{i}/distill_active"] for m in port_steps
               for i in range(4)) > 0
    for k in ("comm/total_bytes", "comm/delivered_bytes",
              "comm/drain_stalls"):
        assert port.metrics[k] == ref.metrics[k], k
    assert port.metrics["comm/delivered_bytes"] == \
        port.metrics["comm/total_bytes"] > 0
    assert port.transport.local_clients == [0, 1, 2, 3]
    assert port.transport._closed  # the runner released the listeners

    loop_steps = []
    loop = PX.Experiment(dataclasses.replace(
        spec, transport=PX.TransportSpec(kind="loopback")),
        device="cpu").run(on_step=lambda t, m: loop_steps.append(m))
    assert loop_steps == port_steps
    assert params_bitwise_equal(loop.trainer.clients, port.trainer.clients)
    assert loop.trainer.meter.by_edge == port.trainer.meter.by_edge
    assert {k: v for k, v in loop.metrics.items()
            if k != "comm/drain_stalls"} == \
        {k: v for k, v in port.metrics.items() if k != "comm/drain_stalls"}


MIXED_STEPS = 10


def _side(X, runner, algorithm, spec, transport, rank, **kw):
    """One package's trainer driving client ``rank`` only, as a gossip
    child builds it (`launch/gossip.py`)."""
    arrays, test_arrays, part = runner.materialize_data(
        spec.data, spec.partition, spec.num_clients)
    algo = X.make_algorithm(spec)
    algo.setup(algorithm.Bindings(
        spec=spec, arrays=arrays, test_arrays=test_arrays, partition=part,
        bundles=runner.build_bundles(spec),
        optimizer=runner.build_optimizer(spec),
        graph=runner.build_graph(spec), transport=transport,
        num_labels=spec.data.num_labels, local_clients=(rank,), **kw))
    return algo.trainer


def test_mixed_fleet_jax_and_torch_gossip_over_tcp(monkeypatch):
    """Client 0 on a JAX trainer and `repro.comm.SocketTransport`, client
    1 on a port trainer and the port's transport, in one process over
    TCP. The two step in turn, phase by phase as one in-process trainer
    orders them (local steps; at a pool round both publish, the frames
    are drained until each receiver has parsed what its sender wrote,
    both deliver and resolve, both pull), so the teacher schedule is the
    in-process one. Each client distills from the other's frames,
    delivered == offered on every edge, and every step metric matches
    the all-reference in-process socket run within the stated
    tolerances."""
    import jax.numpy as jnp

    import repro.comm as RC
    import repro.exp as RX
    import repro.exp.algorithm as ref_algorithm
    import repro.exp.runner as ref_runner
    import repro_torch.exp.algorithm as port_algorithm
    import repro_torch.exp.runner as port_runner
    from repro_torch.core.runtime import batch_to_device

    spec = gossip_spec(PX, MIXED_STEPS, clients=2)
    same_initial_params(monkeypatch, spec)
    ref_spec = RX.ExperimentSpec.from_json(spec.to_json())
    all_ref = []
    RX.Experiment(ref_spec).run(on_step=lambda t, m: all_ref.append(m))

    ta = RC.SocketTransport(2, clients=[0], wait_inflight=False)
    tb = SocketTransport(2, clients=[1], wait_inflight=False)
    ta.set_ports({1: tb.ports[1]})
    tb.set_ports({0: ta.ports[0]})

    def settle():
        """Drain until each receiver has parsed every frame its peer
        wrote."""
        deadline = time.monotonic() + 20
        while ta.recv_count < tb.sent_to[0] or tb.recv_count < ta.sent_to[1]:
            assert time.monotonic() < deadline, "frames never arrived"
            ta.quiesce(settle=0.005, timeout=0.2)
            tb.quiesce(settle=0.005, timeout=0.2)

    try:
        # construction seeds the pools: A publishes and pulls before B
        # has published (the pull waits as pending), B finds A's frame
        A = _side(RX, ref_runner, ref_algorithm, ref_spec, ta, 0)
        settle()
        B = _side(PX, port_runner, port_algorithm, spec, tb, 1,
                  device=torch.device("cpu"))
        settle()
        A.comm_pump(0)  # resolves A's pending pull from B's seed frame
        s_p = spec.algorithm.params["pool_update_every"]
        mixed = []
        for t in range(MIXED_STEPS):
            # each update queued, its metrics read after the comm phase,
            # as one in-process trainer's step() does
            batch = A.public.sample(t)
            pending = [
                A.step_client(A.local[0], {k: jnp.asarray(v)
                                           for k, v in batch.items()},
                              t, defer=True),
                B.step_client(B.local[0], batch_to_device(
                    B.public.sample(t), B.device), t, defer=True)]
            r = t + 1
            if r % s_p == 0:
                A.publish_clients([0], r)
                B.publish_clients([1], r)
                settle()
            A.comm_pump(r)
            B.comm_pump(r)
            if r % s_p == 0:
                A.pull_client(0, r)
                B.pull_client(1, r)
            mixed.append({k: v for resolve in pending
                          for k, v in resolve().items()})
    finally:
        ta.close()
        tb.close()

    assert_step_metrics_close(all_ref, mixed)
    for i in (0, 1):
        assert sum(m[f"c{i}/distill_active"] for m in mixed) > 0, i
    offered = {**A.meter.by_edge, **B.meter.by_edge}
    delivered = {**A.meter.by_edge_delivered, **B.meter.by_edge_delivered}
    assert offered == delivered and set(offered) == {(0, 1), (1, 0)}
    assert ta.sent_to[1] == tb.recv_count and tb.sent_to[0] == ta.recv_count
