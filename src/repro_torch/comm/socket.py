"""TCP-on-localhost transport: the prediction exchange over a real wire
(a copy of ``repro/comm/socket.py``: stdlib plus the port's tracer, and the
same 32-byte ``MHDF`` frame header, so a frame written by either package
parses in the other).

The paper's agents are independent processes that exchange predictions
over a network with no shared memory; `LoopbackTransport` and
`SimulatedNetwork` both live inside one Python process. `SocketTransport`
implements the same ``send(src, dst, payload, step)`` / ``poll(dst,
step)`` interface over real TCP connections on one host, so the
decentralized runtime can be split across OS processes (one per client —
see `launch/gossip.py` and `scripts/port_gossip_procs.py`) with
heterogeneous step rates that are *wall-clock* speed differences, not
simulation ticks.

Topology of sockets
  Each transport instance *hosts* a subset of the clients
  (``clients=``; default all — the in-process configuration). Every
  hosted client owns one listening TCP server socket on a known port
  (``ports[cid]``; port 0 = OS-assigned, read back from ``.ports``).
  A directed edge (src, dst) of the communication graph maps to one
  client connection from src's process to dst's listener — created
  eagerly by ``connect_edges(adjacency)`` (with retries, so processes
  can start in any order) or lazily on the first ``send``. TCP's
  in-order byte stream gives FIFO delivery per edge for free.

Frame protocol
  One message = one length-prefixed frame carrying the byte-exact wire
  codec payload (`wire.py` — the frame never inspects it):

      <4s q q q I : magic b"MHDF", src, dst, sent_step, payload_nbytes>
      <payload_nbytes bytes : codec payload>

  Fixed 32-byte little-endian header; ``sent_step`` travels with the
  frame so the receiver's staleness stamps don't depend on clock
  agreement between processes.

Poll semantics
  ``poll(dst, step)`` performs a *non-blocking* drain: accept pending
  connections, read whatever bytes the kernel has, parse complete
  frames, and return the deliveries whose ``sent_step <= step`` (the
  transport contract: no delivery before the caller's tick — frames
  "from the future" of a faster peer stay queued until the local clock
  catches up). Polling a client this instance does not host returns [].

  ``wait_inflight=True`` (the default when one instance hosts every
  client) additionally blocks until all *locally sent* frames destined
  to ``dst`` have been parsed — in-process, localhost TCP is then
  deterministic and a socket run reproduces the loopback teacher
  schedule exactly (tests/test_torch_socket.py). Multi-process
  instances must leave it off: a receiver cannot know what a remote
  sender still has in flight.
"""
from __future__ import annotations

import contextlib
import socket
import struct
import time
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence

from repro_torch.comm.transport import Delivery, Edge, Transport
from repro_torch.obs import tracer as trace
from repro_torch.obs.tracer import flow_id

_FRAME_MAGIC = b"MHDF"
_HEADER = struct.Struct("<4sqqqI")  # magic, src, dst, sent_step, nbytes

FRAME_HEADER_BYTES = _HEADER.size  # 32


def pack_frame(src: int, dst: int, sent_step: int, payload: bytes) -> bytes:
    return _HEADER.pack(_FRAME_MAGIC, src, dst, sent_step,
                        len(payload)) + payload


def allocate_ports(num_clients: int,
                   host: str = "127.0.0.1") -> Dict[int, int]:
    """Reserve one free TCP port per client by binding throwaway sockets.

    Convenience for single-launcher setups; the gap between releasing a
    port here and the client binding it is a (tiny, localhost-only)
    race. The multi-process launcher avoids it entirely by having each
    child bind port 0 itself and report back (`launch/gossip.py`)."""
    socks = []
    try:
        for _ in range(num_clients):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind((host, 0))
            socks.append(s)
        return {cid: s.getsockname()[1] for cid, s in enumerate(socks)}
    finally:
        for s in socks:
            s.close()


class SocketTransport(Transport):
    """TCP transport hosting ``clients`` (default: all) of a fleet.

    ``ports`` maps client id -> listening port. Hosted clients missing
    from the map bind an OS-assigned port (read ``.ports`` afterwards);
    remote clients' ports may be filled in later via ``set_ports`` —
    they are only needed by the first send on an edge toward them.
    """

    def __init__(self, num_clients: int,
                 clients: Optional[Iterable[int]] = None,
                 ports: Optional[Dict[int, int]] = None,
                 host: str = "127.0.0.1",
                 connect_timeout: float = 20.0,
                 drain_timeout: float = 20.0,
                 send_hard_timeout: Optional[float] = None,
                 wait_inflight: Optional[bool] = None):
        self.num_clients = int(num_clients)
        self.host = host
        self.connect_timeout = float(connect_timeout)
        self.drain_timeout = float(drain_timeout)
        # a send gives up (failed_sends) only after this long; each
        # expired drain_timeout window in between is a metered stall, not
        # a lost frame. Default: 10 stall windows. The gossip launcher
        # passes its own hard run timeout so a send is never the first
        # thing to give up on a slow-but-alive peer (e.g. a rank stalled
        # compiling its kernels for longer than drain_timeout).
        self.send_hard_timeout = (10.0 * self.drain_timeout
                                  if send_hard_timeout is None
                                  else float(send_hard_timeout))
        local = range(num_clients) if clients is None else clients
        self.local_clients = sorted({int(c) for c in local})
        if any(c < 0 or c >= num_clients for c in self.local_clients):
            raise ValueError(f"hosted clients {self.local_clients} out of "
                             f"range for {num_clients} clients")
        self.wait_inflight = (
            len(self.local_clients) == self.num_clients
            if wait_inflight is None else bool(wait_inflight))
        self.ports: Dict[int, int] = {int(c): int(p)
                                      for c, p in (ports or {}).items()}

        self._listeners: Dict[int, socket.socket] = {}
        for cid in self.local_clients:
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind((host, self.ports.get(cid, 0)))
            srv.listen(max(self.num_clients, 8))
            srv.setblocking(False)
            self._listeners[cid] = srv
            self.ports[cid] = srv.getsockname()[1]

        self._out: Dict[Edge, socket.socket] = {}  # edge -> sender conn
        self._dead_edges: set = set()  # peer gone: drop, don't reconnect
        self._in: Dict[int, List[socket.socket]] = {
            cid: [] for cid in self.local_clients}
        self._buffers: Dict[socket.socket, bytearray] = {}
        self._queues: Dict[int, List[Delivery]] = defaultdict(list)
        self._outstanding: Dict[int, int] = defaultdict(int)
        self._closed = False
        self.sent_count = 0
        self.recv_count = 0
        self.sent_bytes = 0
        self.recv_bytes = 0
        self.failed_sends = 0  # peer gone mid-run: the message is lost
        self.corrupt_connections = 0  # non-protocol bytes: conn dropped
        self.drain_stalls = 0  # drain_timeout windows a send sat blocked
        self.undrained_bytes = 0  # partial-frame bytes left at quiesce
        # frames fully written per destination — what the gossip finish
        # barrier's expected-inbound counts are built from
        self.sent_to: Dict[int, int] = defaultdict(int)

    # -- wiring ----------------------------------------------------------

    def set_ports(self, ports: Dict[int, int]) -> None:
        """Fill in (remote) ports learned after construction. A hosted
        client's bound port cannot be changed."""
        for cid, port in ports.items():
            cid, port = int(cid), int(port)
            if cid in self._listeners and self.ports[cid] != port:
                raise ValueError(
                    f"client {cid} is hosted here on port "
                    f"{self.ports[cid]}; cannot remap to {port}")
            self.ports[cid] = port

    def connect_edges(self, adjacency: Sequence[Sequence[int]]) -> None:
        """Eagerly open the per-edge connections this instance sends on:
        every graph edge (src, dst) with a hosted src. Retries until the
        peer's listener is up (``connect_timeout``), so cooperating
        processes may start in any order."""
        for dst, nbrs in enumerate(adjacency):
            for src in nbrs:
                if int(src) in self._listeners:
                    self._connect((int(src), int(dst)))

    def _connect(self, edge: Edge) -> socket.socket:
        src, dst = edge
        port = self.ports.get(dst)
        if port is None:
            raise ValueError(
                f"no port known for client {dst}; pass ports= or call "
                "set_ports() before sending on edge "
                f"({src}, {dst})")
        deadline = time.monotonic() + self.connect_timeout
        with trace.span("socket/connect", src=src, dst=dst, port=port):
            while True:
                try:
                    conn = socket.create_connection(
                        (self.host, port), timeout=self.connect_timeout)
                    break
                except OSError:
                    if time.monotonic() >= deadline:
                        raise
                    time.sleep(0.05)
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._out[edge] = conn
        return conn

    # -- Transport interface ---------------------------------------------

    def send(self, src: int, dst: int, payload: bytes, step: int) -> None:
        if self._closed:
            raise RuntimeError("transport is closed")
        edge = (src, dst)
        if edge in self._dead_edges:
            self.failed_sends += 1
            return
        t0 = trace.now()
        conn = self._out.get(edge)
        if conn is None:
            try:
                conn = self._connect(edge)
            except OSError:
                # unreachable after connect_timeout of retries: the peer
                # is gone for good — tombstone so later sends on a
                # time-varying graph don't re-pay the retry window
                self.failed_sends += 1
                self._dead_edges.add(edge)
                trace.complete("socket/send", t0, src=src, dst=dst,
                               step=step, ok=False)
                return
        frame = pack_frame(src, dst, step, payload)
        try:
            self._send_frame(conn, dst, frame)
        except OSError as e:
            # the frame may be partially written, so this connection's
            # byte stream is unrecoverable either way — drop it. A
            # timeout (slow-but-alive peer, kernel buffer full) permits
            # a fresh connection on the next send; a hard error (peer
            # process exited) tombstones the edge. Never fatal: on a
            # real wire the bytes are simply lost.
            self.failed_sends += 1
            if not isinstance(e, socket.timeout):
                self._dead_edges.add(edge)
            with contextlib.suppress(OSError):
                conn.close()
            self._out.pop(edge, None)
            trace.complete("socket/send", t0, src=src, dst=dst,
                           step=step, ok=False)
            return
        self.sent_count += 1
        self.sent_bytes += len(payload)
        self.sent_to[dst] += 1
        if self.wait_inflight and dst in self._listeners:
            self._outstanding[dst] += 1
        # flow start then the retro-emitted span: the "s" event's
        # timestamp falls inside the span, so Perfetto binds the arrow to
        # this send slice; the receiver emits the matching "f" from the
        # same (src, dst, step) frame-header triple (repro_torch.comm.bus)
        trace.flow_start(flow_id(src, dst, step))
        trace.complete("socket/send", t0, src=src, dst=dst, step=step,
                       nbytes=len(payload))

    def _send_frame(self, conn: socket.socket, dst: int,
                    frame: bytes) -> None:
        """``sendall`` in short slices, draining our own hosted listeners
        between them.

        Two failure modes this neutralizes:

        * in-process (dst hosted here): a frame larger than the kernel's
          socket buffers cannot deadlock the one thread doing both ends —
          draining dst's receive path is interleaved with the write;
        * multi-process: a receiver that stops reading for a while (a
          rank stalled compiling its kernels, a straggler) must not cost us
          the frame *or* deadlock a ring of mutual senders. We keep
          retrying — draining our own inbound edges so peers blocked on
          *us* make progress — and each expired ``drain_timeout`` window
          without a written byte is metered as a ``drain_stalls`` tick
          with exponential backoff, never an error. Only
          ``send_hard_timeout`` (the launcher's hard-timeout scale) makes
          the send give up, and even that surfaces as a failed send, not
          a fleet-killing raise."""
        view = memoryview(frame)
        hard_deadline = time.monotonic() + self.send_hard_timeout
        stall_deadline = time.monotonic() + self.drain_timeout
        backoff = 0.01
        conn.settimeout(0.05)
        try:
            while view:
                try:
                    sent = conn.send(view)
                except socket.timeout:
                    sent = 0
                if sent:
                    view = view[sent:]
                    stall_deadline = time.monotonic() + self.drain_timeout
                    backoff = 0.01
                    continue
                for hosted in self._listeners:
                    self._drain(hosted)
                now = time.monotonic()
                if now >= hard_deadline:
                    raise socket.timeout(
                        f"frame to client {dst} unsent after "
                        f"{self.send_hard_timeout:.0f}s (hard timeout)")
                if now >= stall_deadline:
                    self.drain_stalls += 1
                    trace.instant("socket/drain_stall", dst=dst,
                                  stalls=self.drain_stalls)
                    time.sleep(backoff)
                    backoff = min(backoff * 2.0, 1.0)
                    stall_deadline = time.monotonic() + self.drain_timeout
        finally:
            with contextlib.suppress(OSError):
                conn.settimeout(self.connect_timeout)

    def poll(self, dst: int, step: int) -> List[Delivery]:
        if dst not in self._listeners:
            return []
        self._drain(dst)
        if self.wait_inflight and self._outstanding[dst] > 0:
            t0 = trace.now()
            waiting = self._outstanding[dst]
            deadline = time.monotonic() + self.drain_timeout
            while self._outstanding[dst] > 0:
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"{self._outstanding[dst]} locally sent frame(s) "
                        f"for client {dst} never arrived within "
                        f"{self.drain_timeout}s")
                self._drain(dst, wait=0.005)
            trace.complete("socket/drain_wait", t0, dst=dst,
                           frames=waiting)
        queue = self._queues[dst]
        ready = [d for d in queue if d.sent_step <= step]
        self._queues[dst] = [d for d in queue if d.sent_step > step]
        ready.sort(key=lambda d: (d.sent_step, d.src))
        for d in ready:
            d.recv_step = step
        return ready

    # -- receive path ----------------------------------------------------

    def _drain(self, dst: int, wait: float = 0.0) -> None:
        """Accept pending connections and read whatever has arrived —
        never blocks beyond ``wait`` seconds."""
        srv = self._listeners[dst]
        t0 = trace.now()
        b0, f0 = self.recv_bytes, self.recv_count
        if wait:
            time.sleep(wait)
        while True:
            try:
                conn, _ = srv.accept()
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                break
            conn.setblocking(False)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._in[dst].append(conn)
            self._buffers[conn] = bytearray()
        for conn in list(self._in[dst]):
            buf = self._buffers[conn]
            closed = False
            while True:
                try:
                    chunk = conn.recv(1 << 16)
                except (BlockingIOError, InterruptedError):
                    break
                except OSError:
                    closed = True
                    break
                if not chunk:
                    closed = True
                    break
                buf += chunk
            ok = self._parse_frames(dst, buf)
            if closed or not ok:
                self._in[dst].remove(conn)
                self._buffers.pop(conn, None)
                with contextlib.suppress(OSError):
                    conn.close()
        # emitted only when bytes actually moved: barrier/idle loops call
        # _drain thousands of times and must not flood the ring buffer
        if self.recv_count != f0 or self.recv_bytes != b0:
            trace.complete("socket/drain", t0, dst=dst,
                           frames=self.recv_count - f0,
                           nbytes=self.recv_bytes - b0)

    def _parse_frames(self, dst: int, buf: bytearray) -> bool:
        """Parse complete frames out of ``buf``; returns False when the
        stream is corrupt (bad magic / mis-addressed frame — a stray
        localhost connection, not a peer), telling the caller to drop
        the connection. Receiving, like sending, is never fatal."""
        while len(buf) >= _HEADER.size:
            magic, src, fdst, sent_step, nbytes = _HEADER.unpack_from(buf, 0)
            if magic != _FRAME_MAGIC or fdst != dst:
                self.corrupt_connections += 1
                return False
            if len(buf) < _HEADER.size + nbytes:
                return True
            payload = bytes(buf[_HEADER.size:_HEADER.size + nbytes])
            del buf[:_HEADER.size + nbytes]
            self._queues[dst].append(
                Delivery(int(src), dst, payload, int(sent_step), -1))
            self.recv_count += 1
            self.recv_bytes += nbytes
            if self.wait_inflight and self._outstanding[dst] > 0:
                self._outstanding[dst] -= 1
        return True

    # -- quiesce + snapshot (repro_torch.fleet) --------------------------

    def quiesce(self, settle: float = 0.05, timeout: float = 5.0) -> int:
        """Pull everything the kernel has buffered into the parsed
        hold-back queues: drain every hosted listener until no new bytes
        arrive for ``settle`` seconds (bounded by ``timeout``). After a
        quiesce the only in-flight state a snapshot cannot capture is a
        frame a remote sender has not finished writing; bytes of such
        partial frames left in per-connection buffers are metered in
        ``undrained_bytes``. Returns that leftover byte count."""
        t0 = trace.now()
        deadline = time.monotonic() + timeout
        quiet_at = time.monotonic() + settle
        while time.monotonic() < min(deadline, quiet_at):
            before = self.recv_bytes
            for dst in self._listeners:
                self._drain(dst)
            if self.recv_bytes != before:
                quiet_at = time.monotonic() + settle
            else:
                time.sleep(0.005)
        leftover = sum(len(buf) for buf in self._buffers.values())
        self.undrained_bytes = leftover
        trace.complete("socket/quiesce", t0, leftover=leftover)
        return leftover

    def state_dict(self) -> Dict:
        """The capturable in-flight state: parsed frames held back by the
        no-delivery-before-tick rule, plus the wire counters. Call
        ``quiesce()`` first so kernel-buffered frames are parsed into the
        queues instead of becoming documented losses (`repro_torch.fleet`
        does — see `snapshot.save_fleet`)."""
        return {
            "queues": {int(dst): [(int(d.src), bytes(d.payload),
                                   int(d.sent_step))
                                  for d in q]
                       for dst, q in self._queues.items() if q},
            "counters": {
                "sent_count": int(self.sent_count),
                "recv_count": int(self.recv_count),
                "sent_bytes": int(self.sent_bytes),
                "recv_bytes": int(self.recv_bytes),
                "failed_sends": int(self.failed_sends),
                "drain_stalls": int(self.drain_stalls),
                "undrained_bytes": int(self.undrained_bytes),
                "sent_to": {int(d): int(n)
                            for d, n in self.sent_to.items()},
            },
        }

    def load_state_dict(self, state: Dict) -> None:
        for dst, items in state.get("queues", {}).items():
            self._queues[int(dst)].extend(
                Delivery(int(src), int(dst), bytes(payload),
                         int(sent_step), -1)
                for src, payload, sent_step in items)
        c = state.get("counters", {})
        self.sent_count = int(c.get("sent_count", 0))
        self.recv_count = int(c.get("recv_count", 0))
        self.sent_bytes = int(c.get("sent_bytes", 0))
        self.recv_bytes = int(c.get("recv_bytes", 0))
        self.failed_sends = int(c.get("failed_sends", 0))
        self.drain_stalls = int(c.get("drain_stalls", 0))
        self.undrained_bytes = int(c.get("undrained_bytes", 0))
        for d, n in c.get("sent_to", {}).items():
            self.sent_to[int(d)] = int(n)

    # -- lifecycle -------------------------------------------------------

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for conn in list(self._out.values()):
            with contextlib.suppress(OSError):
                conn.close()
        for conns in self._in.values():
            for conn in conns:
                with contextlib.suppress(OSError):
                    conn.close()
        for srv in self._listeners.values():
            with contextlib.suppress(OSError):
                srv.close()
        self._out.clear()
        self._buffers.clear()

    def __enter__(self) -> "SocketTransport":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # best-effort: tests/examples that forget close()
        with contextlib.suppress(Exception):
            self.close()
