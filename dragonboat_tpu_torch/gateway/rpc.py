"""Networked NodeHost front door: RPC ingress over the TCP framing.

reference: the reference ships no RPC layer of its own — drummer's
nodehost-client talked to remote NodeHosts over a thin request/response
protocol beside the raft transport [U].  This module is that front
door for cross-PROCESS fleets (docs/GATEWAY.md "Networked ingress"):

* :class:`RpcServer` — a listener beside (not inside) a NodeHost's
  raft transport, speaking the same magic/kind/length/crc frames as
  ``transport/tcp.py`` with two new kinds (``KIND_RPC_REQ``/
  ``KIND_RPC_RESP``) and the same versioned-payload discipline.  It
  exposes propose / read (lease fast path, ReadIndex, stale) / session
  register+close / balance stats, bounded by a non-blocking admission
  semaphore — a full server sheds with ``RPC_ERR_BUSY`` instead of
  queueing.
* :class:`RemoteHostHandle` — the client side, duck-typing the
  in-process NodeHost surface the :class:`~.gateway.Gateway`
  multiplexes (``propose``/``try_lease_read``/``sync_read``/session
  ops/``balance_shard_stats``), so a Gateway routes over OS-process
  boundaries exactly like over in-proc hosts.  Degradation contract:
  a torn connection fails every pending op PROMPTLY — exactly-once
  proposals and reads as DROPPED (definitely-not-committed, the
  gateway's retryable outcome), already-sent noop proposals as TIMEOUT
  (maybe-committed; resubmitting would break at-most-once) — and a
  dark remote (breaker open) reports ``_closed`` so routing skips it
  and admission sheds before queueing.  No path blocks a gateway
  worker lane past its own deadline.
* :class:`RouteFeeder` — the gossip-backed routing loop: a
  ``balance.Collector`` over the gateway's (remote) hosts, liveness
  from ``GossipManager.alive_peers``, feeding
  ``RoutingCache.refresh_from_view`` and dropping routes to hosts the
  view no longer contains.  A multi-process fleet converges on leader
  changes with zero shared memory.
"""
from __future__ import annotations

import json
import socket
import struct
import threading
import time
from typing import Dict, Optional

from ..client import SERIES_ID_FIRST_PROPOSAL, Session
from ..logger import get_logger
from ..obs.fleetscope import ObsService, ObsUnsupported
from ..obs.trace import UNSAMPLED
from ..nodehost import (
    NodeHostClosed,
    RequestDropped,
    RequestRejected,
    RequestTerminated,
    TimeoutError_,
    _CODE_ERRORS,
)
from ..readplane import (
    BOUND_TICKS_DEFAULT,
    PATH_BOUNDED,
    ReadResult,
    ReadUnsupported,
    StaleBoundExceeded,
)
from ..request import (
    RequestError,
    RequestResultCode,
    ShardNotFound,
    SystemBusy,
)
from ..statemachine import Result
from ..transport.tcp import _read_frame, _write_frame, parse_address
from ..transport.transport import _OPEN, _Breaker
from ..transport.wire import (
    KIND_RPC_REQ,
    KIND_RPC_RESP,
    RPC_ERR,
    RPC_ERR_BUSY,
    RPC_ERR_DENIED,
    RPC_ERR_NO_LEASE,
    RPC_ERR_NOT_FOUND,
    RPC_ERR_STALE_BOUND,
    RPC_OBS_METRICS,
    RPC_OBS_RECORDER,
    RPC_OBS_SPANS,
    RPC_OP_FAULT,
    RPC_OP_OBS,
    RPC_OP_PROPOSE,
    RPC_OP_READ,
    RPC_OP_SESSION_CLOSE,
    RPC_OP_SESSION_OPEN,
    RPC_OP_STATS,
    RPC_READ_BOUNDED,
    RPC_READ_FOLLOWER,
    RPC_READ_INDEX,
    RPC_READ_LEASE,
    RPC_READ_STALE,
    RPC_STATS_READ_PATHS,
    RpcRequest,
    RpcResponse,
    WireError,
    decode_obs_query,
    decode_obs_reply,
    decode_rpc_request,
    decode_rpc_response,
    decode_rpc_stats,
    decode_rpc_value,
    encode_obs_query,
    encode_obs_reply,
    encode_rpc_request,
    encode_rpc_response,
    encode_rpc_stats,
    encode_rpc_value,
)

_log = get_logger("gateway")

_COMPLETED = int(RequestResultCode.COMPLETED)


class _WireCtx:
    """Trace context lifted off an RPC request frame — exactly the two
    fields ``NodeHost.propose``'s ``parent`` contract reads, so a
    gateway client's root span stitches into the server-side
    request→raft→apply spans."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: int, span_id: int):
        self.trace_id = trace_id
        self.span_id = span_id


class RpcLeaseNotHeld(RequestError):
    """Lease-only read on a host not holding the lease (fall back)."""


class RpcDenied(RequestError):
    """Operation disabled on this server (e.g. fault ops in prod)."""


def _err_name(code) -> str:
    try:
        return RequestResultCode(code).name
    except ValueError:
        return f"rpc-code-{code:#x}"


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------
class RpcServer:
    """One listening ingress for one NodeHost.

    Lifecycle mirrors TCPTransport: ``start()`` binds (port 0 rewrites
    ``listen_address``), one accept loop, one reader thread per client
    connection; request handling fans out to short-lived worker
    threads bounded by ``max_inflight`` — acquisition is NON-blocking,
    so overload answers ``RPC_ERR_BUSY`` immediately instead of
    building a queue the client's deadline can't see (the admission
    plane's shed-at-the-door policy, docs/GATEWAY.md).

    ``fault_controller``+``allow_fault_ops`` expose the nemesis plane
    to the multi-process scenario harness (``RPC_OP_FAULT`` activates /
    heals wire faults on THIS host's transport); production servers
    leave it off and the op answers ``RPC_ERR_DENIED``.
    """

    def __init__(
        self,
        nh,
        listen_address: str,
        *,
        fault_controller=None,
        allow_fault_ops: bool = False,
        enable_obs_ops: bool = True,
        max_inflight: int = 64,
        wait_grace: float = 0.25,
    ):
        self._nh = nh
        self.listen_address = listen_address
        self._fault = fault_controller
        self._allow_fault_ops = allow_fault_ops
        # enable_obs_ops=False simulates a pre-obs server binary:
        # RPC_OP_OBS falls through to "unknown op" and collectors mark
        # the process no-obs (the degrade matrix's testable hinge)
        self._enable_obs_ops = enable_obs_ops
        self._obs = ObsService(nh)
        self._sem = threading.Semaphore(max_inflight)
        # wait() a touch past the client's own deadline so the CLIENT
        # observes its timeout first and the reply (late TIMEOUT) is
        # dropped by its gone pending entry, not raced
        self._wait_grace = wait_grace
        self._listener: Optional[socket.socket] = None
        self._stop = threading.Event()
        self._threads = []
        self._conn_lock = threading.Lock()
        self._inbound = set()

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        host, port = parse_address(self.listen_address)
        ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ls.bind((host, port))
        ls.listen(128)
        ls.settimeout(0.2)
        self._listener = ls
        self.listen_address = f"{host}:{ls.getsockname()[1]}"
        t = threading.Thread(
            target=self._accept_main, daemon=True, name="tpu-rpc-accept"
        )
        t.start()
        self._threads.append(t)

    def close(self) -> None:
        self._stop.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        with self._conn_lock:
            socks = list(self._inbound)
            self._inbound.clear()
        for s in socks:
            try:
                s.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=1.0)

    # -- inbound ---------------------------------------------------------
    def _accept_main(self) -> None:
        while not self._stop.is_set():
            try:
                sock, _addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conn_lock:
                self._inbound.add(sock)
            t = threading.Thread(
                target=self._conn_main,
                args=(sock,),
                daemon=True,
                name="tpu-rpc-reader",
            )
            t.start()

    def _conn_main(self, sock) -> None:
        # one write lock per connection: replies from concurrent worker
        # threads interleave whole frames, never bytes
        wlock = threading.Lock()
        try:
            while not self._stop.is_set():
                frame = _read_frame(sock)
                if frame is None:
                    return
                kind, payload = frame
                if kind != KIND_RPC_REQ:
                    raise WireError(f"unexpected frame kind {kind}")
                q = decode_rpc_request(payload)
                if not self._sem.acquire(blocking=False):
                    # shed, don't queue: the client retries against its
                    # breaker/backoff, and a bounded server can't build
                    # an invisible latency queue
                    self._reply(sock, wlock, RpcResponse(
                        req_id=q.req_id, code=RPC_ERR_BUSY,
                        error="rpc server at max inflight",
                    ))
                    continue
                t = threading.Thread(
                    target=self._serve_one,
                    args=(sock, wlock, q),
                    daemon=True,
                    name="tpu-rpc-worker",
                )
                t.start()
        except (WireError, ValueError) as e:
            _log.warning("rpc: closing connection on bad frame: %s", e)
        except OSError:
            pass
        finally:
            with self._conn_lock:
                self._inbound.discard(sock)
            try:
                sock.close()
            except OSError:
                pass

    def _serve_one(self, sock, wlock, q: RpcRequest) -> None:
        try:
            p = self._handle(q)
        except Exception as e:  # noqa: BLE001 — reply, never kill the conn
            p = RpcResponse(req_id=q.req_id, code=RPC_ERR,
                            error=f"{type(e).__name__}: {e}")
        finally:
            self._sem.release()
        self._reply(sock, wlock, p)

    @staticmethod
    def _reply(sock, wlock, p: RpcResponse) -> None:
        buf = encode_rpc_response(p)
        try:
            with wlock:
                _write_frame(sock, KIND_RPC_RESP, buf)
        except OSError:
            # client gone; its side fails pending ops via teardown
            pass

    # -- dispatch --------------------------------------------------------
    def _handle(self, q: RpcRequest) -> RpcResponse:
        nh = self._nh
        timeout = max(0.05, q.timeout_ms / 1000.0)
        try:
            if q.op == RPC_OP_PROPOSE:
                s = Session(shard_id=q.shard_id, client_id=q.client_id,
                            series_id=q.series_id,
                            responded_to=q.responded_to)
                # trace context off the frame: the server-side propose
                # span continues the CLIENT's trace (cross-process
                # stitch); trace_id 0 = untraced request
                parent = (
                    _WireCtx(q.trace_id, q.span_id) if q.trace_id else None
                )
                rs = nh.propose(s, q.payload, timeout, parent=parent)
                # sliced wait: a NodeHost closed mid-flight leaves its
                # RequestStates permanently pending — detecting that
                # here turns a full client-timeout stall into a fast
                # NOT_FOUND (client maps it to retryable DROPPED)
                deadline = time.monotonic() + timeout + self._wait_grace
                while (not rs._event.is_set()
                       and time.monotonic() < deadline):
                    if getattr(nh, "_closed", False):
                        raise NodeHostClosed(
                            "nodehost closed while proposal pending")
                    rs._event.wait(0.05)
                code = rs.wait(0.001)
                resp = RpcResponse(req_id=q.req_id, code=int(code))
                if code == RequestResultCode.COMPLETED and rs.result is not None:
                    resp.value = int(getattr(rs.result, "value", 0) or 0)
                    resp.data = bytes(getattr(rs.result, "data", b"") or b"")
                return resp
            if q.op == RPC_OP_READ:
                return self._handle_read(q, timeout)
            if q.op == RPC_OP_SESSION_OPEN:
                s = nh.sync_get_session(q.shard_id, timeout=timeout)
                return RpcResponse(req_id=q.req_id, code=_COMPLETED,
                                   value=s.client_id)
            if q.op == RPC_OP_SESSION_CLOSE:
                s = Session(shard_id=q.shard_id, client_id=q.client_id,
                            series_id=q.series_id,
                            responded_to=q.responded_to)
                nh.sync_close_session(s, timeout=timeout)
                return RpcResponse(req_id=q.req_id, code=_COMPLETED)
            if q.op == RPC_OP_STATS:
                rp = None
                if q.flags & RPC_STATS_READ_PATHS:
                    fn = getattr(nh, "read_path_counts", None)
                    rp = fn() if callable(fn) else {}
                data = encode_rpc_stats(
                    getattr(nh, "nodehost_id", "") or "",
                    nh.raft_address(), nh.balance_shard_stats(),
                    read_paths=rp,
                )
                return RpcResponse(req_id=q.req_id, code=_COMPLETED,
                                   data=data)
            if q.op == RPC_OP_FAULT:
                if not self._allow_fault_ops or self._fault is None:
                    return RpcResponse(req_id=q.req_id, code=RPC_ERR_DENIED,
                                       error="fault ops disabled")
                return self._handle_fault(q)
            if q.op == RPC_OP_OBS and self._enable_obs_ops:
                return self._handle_obs(q)
            return RpcResponse(req_id=q.req_id, code=RPC_ERR,
                               error=f"unknown op {q.op}")
        except SystemBusy as e:
            return RpcResponse(req_id=q.req_id, code=RPC_ERR_BUSY,
                               error=str(e) or "busy")
        except (ShardNotFound, NodeHostClosed) as e:
            return RpcResponse(req_id=q.req_id, code=RPC_ERR_NOT_FOUND,
                               error=f"{type(e).__name__}: {e}")
        except TimeoutError_:
            return RpcResponse(req_id=q.req_id,
                               code=int(RequestResultCode.TIMEOUT))
        except RequestRejected:
            return RpcResponse(req_id=q.req_id,
                               code=int(RequestResultCode.REJECTED))
        except RequestDropped:
            return RpcResponse(req_id=q.req_id,
                               code=int(RequestResultCode.DROPPED))
        except RequestTerminated:
            return RpcResponse(req_id=q.req_id,
                               code=int(RequestResultCode.TERMINATED))

    def _handle_read(self, q: RpcRequest, timeout: float) -> RpcResponse:
        nh = self._nh
        query = decode_rpc_value(q.payload)
        if q.flags == RPC_READ_LEASE:
            ok, val = nh.try_lease_read(
                q.shard_id, query, margin_ticks=q.arg or 2
            )
            if not ok:
                return RpcResponse(req_id=q.req_id, code=RPC_ERR_NO_LEASE,
                                   error="lease not held")
        elif q.flags == RPC_READ_INDEX:
            val = nh.sync_read(q.shard_id, query, timeout=timeout)
        elif q.flags == RPC_READ_STALE:
            val = nh.stale_read(q.shard_id, query)
        elif q.flags == RPC_READ_FOLLOWER:
            # ReadIndex round via the leader, served from THIS host's
            # state machine; value = applied index (the stamp)
            val, applied = nh.follower_read(q.shard_id, query,
                                            timeout=timeout)
            return RpcResponse(req_id=q.req_id, code=_COMPLETED,
                               value=applied, data=encode_rpc_value(val))
        elif q.flags == RPC_READ_BOUNDED:
            try:
                res = nh.bounded_read(
                    q.shard_id, query,
                    bound_ticks=q.arg or BOUND_TICKS_DEFAULT,
                )
            except StaleBoundExceeded as e:
                return RpcResponse(req_id=q.req_id,
                                   code=RPC_ERR_STALE_BOUND,
                                   error=str(e) or "stale bound exceeded")
            # stamp rides value (applied) + a u32 staleness prefix on
            # data — binary, so bytes-typed SM values survive intact
            data = struct.pack("<I", res.staleness_ticks)
            data += encode_rpc_value(res.value)
            return RpcResponse(req_id=q.req_id, code=_COMPLETED,
                               value=res.applied_index, data=data)
        else:
            return RpcResponse(req_id=q.req_id, code=RPC_ERR,
                               error=f"unknown read mode {q.flags}")
        return RpcResponse(req_id=q.req_id, code=_COMPLETED,
                           data=encode_rpc_value(val))

    def _handle_obs(self, q: RpcRequest) -> RpcResponse:
        """Fleet-scope telemetry queries (``RPC_OP_OBS``, sub-kind in
        ``flags``).  The query's ``epoch`` is client-held bookkeeping
        (restart detection happens collector-side against the epoch in
        the reply) — the server only honors cursor+limit."""
        try:
            cursor, _epoch, limit = decode_obs_query(q.payload)
        except WireError as e:
            return RpcResponse(req_id=q.req_id, code=RPC_ERR,
                               error=f"bad obs query: {e}")
        if q.flags == RPC_OBS_METRICS:
            reply = self._obs.metrics_snapshot()
        elif q.flags == RPC_OBS_RECORDER:
            reply = self._obs.recorder_tail(cursor, limit=limit)
        elif q.flags == RPC_OBS_SPANS:
            reply = self._obs.trace_spans(cursor, limit=limit)
        else:
            return RpcResponse(req_id=q.req_id, code=RPC_ERR,
                               error=f"unknown obs kind {q.flags}")
        return RpcResponse(req_id=q.req_id, code=_COMPLETED,
                           data=encode_obs_reply(reply))

    def _handle_fault(self, q: RpcRequest) -> RpcResponse:
        from .. import faults as faults_mod

        try:
            spec = json.loads(q.payload.decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as e:
            return RpcResponse(req_id=q.req_id, code=RPC_ERR,
                               error=f"bad fault spec: {e}")
        action = spec.get("action")
        if action == "heal_wire":
            self._fault.heal_wire()
        elif action == "heal_all":
            self._fault.heal_all()
        elif action == "activate":
            f = spec.get("fault") or {}
            try:
                fault = faults_mod.Fault(
                    kind=f["kind"],
                    at=0.0,
                    duration=float(f.get("duration", 0.0)),
                    targets=tuple(f.get("targets", ())),
                    p=float(f.get("p", 1.0)),
                    delay=float(f.get("delay", 0.05)),
                    both_ways=bool(f.get("both_ways", True)),
                )
            except (KeyError, TypeError, ValueError) as e:
                return RpcResponse(req_id=q.req_id, code=RPC_ERR,
                                   error=f"bad fault spec: {e}")
            self._fault.activate(fault)
        else:
            return RpcResponse(req_id=q.req_id, code=RPC_ERR,
                               error=f"unknown fault action {action!r}")
        return RpcResponse(req_id=q.req_id, code=_COMPLETED)


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------
class _RemoteCall:
    """RequestState-compatible completion for one in-flight RPC.

    Same discipline as request.RequestState: ``notify`` writes
    ``code``/``result`` BEFORE setting ``_event`` — a set event is a
    complete, readable outcome (the gateway's ``_poll_finish`` peeks
    ``_event.is_set()`` without any lock)."""

    __slots__ = ("req_id", "op", "noop", "sent", "expires", "code",
                 "result", "resp", "error", "span", "traced", "_event")

    def __init__(self, req_id: int, op: int, noop: bool, expires: float):
        self.req_id = req_id
        self.op = op
        self.noop = noop
        self.sent = False
        self.expires = expires
        self.code: Optional[RequestResultCode] = None
        self.result: Optional[Result] = None
        self.resp: Optional[RpcResponse] = None
        self.error = ""
        # client-side rpc span (ends in notify — the single completion
        # point); traced = this frame carried trace context on the wire
        self.span = None
        self.traced = False
        self._event = threading.Event()

    def notify(self, code: RequestResultCode, result=None, resp=None,
               error: str = "") -> None:
        self.code = code
        self.result = result
        self.resp = resp
        self.error = error
        self._event.set()
        sp = self.span
        if sp is not None:
            sp.end(
                "ok" if code == RequestResultCode.COMPLETED else code.name
            )

    def wait(self, timeout: float) -> RequestResultCode:
        if not self._event.wait(timeout):
            return RequestResultCode.TIMEOUT
        return self.code


class _RemoteConfig:
    """The one config field gateway/scenario helpers read off a host."""

    __slots__ = ("rtt_millisecond",)

    def __init__(self, rtt_millisecond: int):
        self.rtt_millisecond = rtt_millisecond


class RemoteHostHandle:
    """A NodeHost you can only reach over the wire.

    Duck-types the in-proc surface :class:`~.gateway.Gateway` and the
    balance Collector consume, over ONE long-lived RPC connection
    multiplexed by request id.  Shard placement / leadership questions
    (``_get_node``/``is_leader_of``/``get_leader_id``) answer from a
    briefly-cached STATS snapshot so routing sweeps don't issue one
    network round trip per shard per sweep.

    Failure semantics (docs/GATEWAY.md "Degradation matrix"):

    * breaker OPEN and still cooling → ``_closed`` is True (routing
      skips the host; ``propose`` raises SystemBusy = shed before
      queueing);
    * connect/send failure → breaker failure + every pending op fails
      NOW: DROPPED for reads, session ops and exactly-once proposals
      (definitely-not-committed → the gateway retries them), TIMEOUT
      for noop proposals already on the wire (maybe committed —
      at-most-once forbids resubmission);
    * a response that never comes → the caller's own bounded ``wait``
      returns TIMEOUT; an expiry sweep GCs the pending entry.
    """

    def __init__(
        self,
        address: str,
        *,
        connect_timeout: float = 1.0,
        rtt_millisecond: int = 20,
        stats_max_age: float = 0.25,
        stats_timeout: float = 1.0,
        lease_timeout: float = 0.5,
        propose_attempt_cap: float = 2.0,
        breaker: Optional[_Breaker] = None,
        tracer=None,
    ):
        self.address = address
        self.config = _RemoteConfig(rtt_millisecond)
        # attrs the gateway probes with getattr(): no recorder/
        # transport plane on a remote handle (cap feedback, shed dumps
        # and event taps stay host-side).  ``tracer`` is the CLIENT
        # process's tracer: propose starts an rpc:propose span whose
        # context rides the request frame — the server-side spans
        # continue it (the cross-process stitch).
        self.recorder = None
        self.tracer = tracer
        self.transport = None
        # trace degrade latch: old servers reject v1 frames by tearing
        # the connection; a teardown with traced frames in flight
        # before ANY traced exchange succeeded latches tracing off for
        # this address (retries go untraced = byte-identical v0)
        self._trace_confirmed = False
        self._trace_disabled = False
        self._connect_timeout = connect_timeout
        self._stats_max_age = stats_max_age
        self._stats_timeout = stats_timeout
        self._lease_timeout = lease_timeout
        self._propose_attempt_cap = propose_attempt_cap
        self._breaker = breaker if breaker is not None else _Breaker()
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._pending: Dict[int, _RemoteCall] = {}
        self._req_seq = 0
        self._closed_flag = False
        # stats snapshot (balance rows + remote identity + read paths)
        self._stats_rows = None
        self._stats_nhid = ""
        self._stats_raft = ""
        self._stats_read_paths: Dict[str, int] = {}
        self._stats_t = 0.0

    # -- liveness ---------------------------------------------------------
    @property
    def _closed(self) -> bool:  # gateway-hot
        """True when explicitly closed OR dark (breaker open, still
        cooling, no live connection).  Deliberately does NOT call
        ``_Breaker.ready()`` — that consumes the half-open probe; this
        is a pure state read so routing sweeps can poll it freely."""
        if self._closed_flag:
            return True
        b = self._breaker
        return (
            self._sock is None
            and b.state == _OPEN
            and (time.monotonic() - b.opened_at) < b._wait
        )

    @property
    def nodehost_id(self) -> str:
        """Remote NodeHostID (known after the first STATS exchange);
        the RouteFeeder's join key against gossip liveness."""
        return self._stats_nhid

    def close(self) -> None:
        with self._lock:
            self._closed_flag = True
            sock, self._sock = self._sock, None
            pending, self._pending = self._pending, {}
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        for rc in pending.values():
            self._fail_rc(rc, "handle closed")

    # -- connection -------------------------------------------------------
    def _ensure_conn(self) -> socket.socket:
        with self._lock:
            if self._closed_flag:
                raise NodeHostClosed("remote handle closed")
            if self._sock is not None:
                return self._sock
            if not self._breaker.ready():
                raise SystemBusy(
                    f"remote {self.address} dark (breaker open)"
                )
        # connect OUTSIDE the lock: a slow remote must not block every
        # other caller of this handle for the connect timeout
        try:
            sock = socket.create_connection(
                parse_address(self.address), timeout=self._connect_timeout
            )
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.settimeout(None)
        except OSError as e:
            self._breaker.failure()
            raise RequestDropped(f"connect {self.address}: {e}")
        with self._lock:
            if self._closed_flag:
                try:
                    sock.close()
                except OSError:
                    pass
                raise NodeHostClosed("remote handle closed")
            if self._sock is not None:
                # lost the race; ride the established connection
                try:
                    sock.close()
                except OSError:
                    pass
                return self._sock
            self._sock = sock
        self._breaker.success()
        t = threading.Thread(
            target=self._reader_main, args=(sock,),
            daemon=True, name="tpu-rpc-client-reader",
        )
        t.start()
        return sock

    def _teardown(self, sock, why: str) -> None:
        """Connection died: fail EVERY pending op now, per the
        degradation matrix — a worker lane polls completed state, it
        must never inherit a wedged socket's silence."""
        with self._lock:
            if self._sock is sock:
                self._sock = None
                pending, self._pending = self._pending, {}
            else:
                pending = {}
        try:
            sock.close()
        except OSError:
            pass
        if pending:
            _log.warning(
                "rpc %s: connection lost (%s); failing %d pending",
                self.address, why, len(pending),
            )
        if (
            not self._trace_confirmed
            and not self._trace_disabled
            and any(rc.traced for rc in pending.values())
        ):
            # an old server tears the connection on the first v1 frame
            # it sees — before any traced exchange has ever succeeded
            # that teardown is indistinguishable from "doesn't speak
            # v1", so degrade: this handle goes untraced from here on
            self._trace_disabled = True
            _log.warning(
                "rpc %s: tore connection on traced frame before any "
                "confirmation; disabling trace context (old server?)",
                self.address,
            )
        self._breaker.failure()
        for rc in pending.values():
            self._fail_rc(rc, why)

    def _fail_rc(self, rc: _RemoteCall, why: str) -> None:
        if rc.op == RPC_OP_PROPOSE and rc.noop and rc.sent:
            # a noop proposal already on the wire MAY have committed:
            # TIMEOUT keeps it ambiguous and non-retryable (at-most-once)
            rc.notify(RequestResultCode.TIMEOUT, error=why)
        else:
            rc.notify(RequestResultCode.DROPPED, error=why)

    # -- submit/complete plumbing ----------------------------------------
    def _submit(
        self,
        op: int,
        *,
        flags: int = 0,
        shard_id: int = 0,
        session: Optional[Session] = None,
        timeout: float = 1.0,
        arg: int = 0,
        payload: bytes = b"",
        span=None,
    ) -> _RemoteCall:
        timeout_ms = max(50, min(int(timeout * 1000.0), 0xFFFFFFFF))
        q = RpcRequest(
            op=op, flags=flags, shard_id=shard_id,
            client_id=session.client_id if session is not None else 0,
            series_id=session.series_id if session is not None else 0,
            responded_to=session.responded_to if session is not None else 0,
            timeout_ms=timeout_ms, arg=arg, payload=payload,
        )
        traced = span is not None and not self._trace_disabled
        if traced:
            q.trace_id = span.trace_id
            q.span_id = span.span_id
        buf_noop = session is None or session.is_noop()
        sock = self._ensure_conn()
        now = time.monotonic()
        with self._lock:
            if self._sock is not sock:
                raise RequestDropped("connection lost before send")
            self._req_seq += 1
            q.req_id = self._req_seq
            rc = _RemoteCall(q.req_id, op, buf_noop,
                             now + timeout_ms / 1000.0 + 5.0)
            rc.span = span
            rc.traced = traced
            self._pending[q.req_id] = rc
            expired = [
                p for p in self._pending.values()
                if p.expires < now and not p._event.is_set()
            ]
            for p in expired:
                del self._pending[p.req_id]
        for p in expired:
            # server never answered inside its grace: ambiguous
            p.notify(RequestResultCode.TIMEOUT, error="rpc expiry sweep")
        buf = encode_rpc_request(q)
        rc.sent = True
        try:
            with self._lock:
                if self._sock is not sock:
                    raise OSError("connection replaced")
                _write_frame(sock, KIND_RPC_REQ, buf)
        except OSError as e:
            self._teardown(sock, f"send: {e}")
            # rc was completed by the teardown sweep (matrix applied)
        return rc

    def _reader_main(self, sock) -> None:
        why = "eof"
        try:
            while True:
                frame = _read_frame(sock)
                if frame is None:
                    break
                kind, payload = frame
                if kind != KIND_RPC_RESP:
                    raise WireError(f"unexpected frame kind {kind}")
                p = decode_rpc_response(payload)
                with self._lock:
                    rc = self._pending.pop(p.req_id, None)
                if rc is not None:
                    self._complete(rc, p)
        except (WireError, ValueError) as e:
            why = f"bad frame: {e}"
        except OSError as e:
            why = f"recv: {e}"
        self._teardown(sock, why)

    def _complete(self, rc: _RemoteCall, p: RpcResponse) -> None:
        self._breaker.success()
        if rc.traced:
            # a traced frame got a reply: the server speaks v1, the
            # degrade latch can never fire for this handle again
            self._trace_confirmed = True
        if rc.op == RPC_OP_PROPOSE:
            if p.code <= int(RequestResultCode.COMMITTED):
                code = RequestResultCode(p.code)
                result = (
                    Result(p.value, p.data)
                    if code == RequestResultCode.COMPLETED else None
                )
                rc.notify(code, result=result, resp=p, error=p.error)
            else:
                # ingress-level outcomes (BUSY/NOT_FOUND/...) all mean
                # the proposal never reached a pending table: DROPPED
                # is the dedupe-safe, retryable mapping
                rc.notify(RequestResultCode.DROPPED, resp=p,
                          error=p.error or _err_name(p.code))
        else:
            code = (
                RequestResultCode(p.code)
                if p.code <= int(RequestResultCode.COMMITTED)
                else RequestResultCode.REJECTED
            )
            if code == RequestResultCode.COMPLETED:
                rc.notify(code, result=Result(p.value, p.data), resp=p)
            else:
                rc.notify(code, resp=p, error=p.error or _err_name(p.code))

    def _finish(self, rc: _RemoteCall, timeout: float):
        """Bounded wait + error mapping for the synchronous wrappers."""
        code = rc.wait(timeout)
        p = rc.resp
        if p is not None and p.code > int(RequestResultCode.COMMITTED):
            if p.code == RPC_ERR_BUSY:
                raise SystemBusy(p.error or "remote busy")
            if p.code == RPC_ERR_NOT_FOUND:
                raise ShardNotFound(p.error or "not on remote")
            if p.code == RPC_ERR_NO_LEASE:
                raise RpcLeaseNotHeld(p.error or "lease not held")
            if p.code == RPC_ERR_DENIED:
                raise RpcDenied(p.error or "denied")
            if p.code == RPC_ERR_STALE_BOUND:
                raise StaleBoundExceeded(p.error or "stale bound exceeded")
            if p.code == RPC_ERR and "unknown read mode" in p.error:
                # pre-readplane server: the caller degrades to a
                # leader read (docs/READPLANE.md "Version skew")
                raise ReadUnsupported(p.error)
            raise RequestError(p.error or _err_name(p.code))
        if code == RequestResultCode.COMPLETED:
            return rc.result
        raise _CODE_ERRORS.get(code, RequestError)(
            rc.error or _err_name(code)
        )

    # -- NodeHost surface (what the Gateway multiplexes) ------------------
    def propose(self, session: Session, cmd: bytes, timeout: float,
                parent=None) -> _RemoteCall:
        if not session.is_noop():
            # per-ATTEMPT bound, not per-op: an exactly-once proposal
            # that lands on a follower right as the leader dies is
            # forwarded into the void and its RequestState pends until
            # the server-side wait expires — letting one attempt carry
            # the caller's whole budget wedges the gateway lane for
            # exactly the window a kill needs retries.  TIMEOUT at the
            # cap is retryable for exactly-once sessions (the series
            # dedupes); noop proposals are never retried, so their one
            # attempt keeps the caller's full timeout.
            timeout = min(timeout, self._propose_attempt_cap)
        # root span for the wire hop: its context rides the request
        # frame, so the server-side request→raft→apply spans stitch
        # into the SAME trace.  parent=None roots a new trace here;
        # a caller-held parent is continued; UNSAMPLED propagates the
        # root's no (same contract as NodeHost.propose).
        span = None
        tracer = self.tracer
        if tracer is not None and not self._trace_disabled:
            if parent is None:
                span = tracer.start_trace("rpc:propose", session.shard_id)
            elif parent is not UNSAMPLED:
                span = tracer.start_span(
                    "rpc:propose", parent.trace_id, parent.span_id,
                    session.shard_id,
                )
        try:
            return self._submit(
                RPC_OP_PROPOSE, shard_id=session.shard_id, session=session,
                timeout=timeout, payload=cmd, span=span,
            )
        except (RequestDropped, SystemBusy, OSError) as e:
            # unreachable OR breaker-dark remote: complete as DROPPED
            # instead of raising — the gateway's _propose_once treats
            # raised errors as TERMINAL, but DROPPED is retryable
            # through other hosts
            rc = _RemoteCall(0, RPC_OP_PROPOSE, session.is_noop(), 0.0)
            rc.span = span
            rc.notify(RequestResultCode.DROPPED, error=str(e))
            return rc

    def sync_propose(self, session: Session, cmd: bytes,
                     timeout: float = 5.0, parent=None):
        # parent mirrors NodeHost.sync_propose: a tracer-holding handle
        # is a drop-in nodehost for propose_with_retry, whose root span
        # arrives here and parents the rpc:propose wire hop
        rc = self.propose(session, cmd, timeout, parent=parent)
        return self._finish(rc, timeout + 0.5)

    def try_lease_read(self, shard_id: int, query, margin_ticks: int = 2):
        if self._closed:
            return False, None
        try:
            rc = self._submit(
                RPC_OP_READ, flags=RPC_READ_LEASE, shard_id=shard_id,
                timeout=self._lease_timeout, arg=margin_ticks,
                payload=encode_rpc_value(query),
            )
        except (RequestError, OSError):
            return False, None
        if rc.wait(self._lease_timeout + 0.25) != RequestResultCode.COMPLETED:
            return False, None
        return True, decode_rpc_value(rc.result.data)

    def sync_read(self, shard_id: int, query, timeout: float = 5.0):
        rc = self._submit(
            RPC_OP_READ, flags=RPC_READ_INDEX, shard_id=shard_id,
            timeout=timeout, payload=encode_rpc_value(query),
        )
        result = self._finish(rc, timeout + 0.5)
        return decode_rpc_value(result.data)

    def stale_read(self, shard_id: int, query):
        rc = self._submit(
            RPC_OP_READ, flags=RPC_READ_STALE, shard_id=shard_id,
            timeout=self._stats_timeout, payload=encode_rpc_value(query),
        )
        result = self._finish(rc, self._stats_timeout + 0.5)
        return decode_rpc_value(result.data)

    def follower_read(self, shard_id: int, query, timeout: float = 5.0):
        """(value, applied_index) served from the REMOTE host's state
        machine after its ReadIndex round — the NodeHost.follower_read
        surface over the wire.  Raises ReadUnsupported against a
        pre-readplane server (caller degrades to a leader read)."""
        rc = self._submit(
            RPC_OP_READ, flags=RPC_READ_FOLLOWER, shard_id=shard_id,
            timeout=timeout, payload=encode_rpc_value(query),
        )
        result = self._finish(rc, timeout + 0.5)
        return decode_rpc_value(result.data), result.value

    def bounded_read(self, shard_id: int, query,
                     bound_ticks: int = BOUND_TICKS_DEFAULT) -> ReadResult:
        """Bounded-staleness read off the remote's local state; the
        stamp rides value (applied) + a u32 staleness prefix on data.
        Raises StaleBoundExceeded on a shed, ReadUnsupported against a
        pre-readplane server."""
        rc = self._submit(
            RPC_OP_READ, flags=RPC_READ_BOUNDED, shard_id=shard_id,
            timeout=self._stats_timeout, arg=bound_ticks,
            payload=encode_rpc_value(query),
        )
        result = self._finish(rc, self._stats_timeout + 0.5)
        if len(result.data) < 4:
            raise RequestError("bounded read: short stamp")
        (staleness,) = struct.unpack_from("<I", result.data, 0)
        return ReadResult(
            decode_rpc_value(result.data[4:]), PATH_BOUNDED,
            applied_index=result.value, staleness_ticks=staleness,
        )

    def get_noop_session(self, shard_id: int) -> Session:
        return Session.noop(shard_id)

    def sync_get_session(self, shard_id: int, timeout: float = 5.0) -> Session:
        rc = self._submit(RPC_OP_SESSION_OPEN, shard_id=shard_id,
                          timeout=timeout)
        result = self._finish(rc, timeout + 0.5)
        # the server already ran prepare_for_propose on its side; the
        # fresh client-side session starts at the first series id
        return Session(
            shard_id=shard_id, client_id=result.value,
            series_id=SERIES_ID_FIRST_PROPOSAL, responded_to=0,
        )

    def sync_close_session(self, session: Session,
                           timeout: float = 5.0) -> None:
        rc = self._submit(RPC_OP_SESSION_CLOSE,
                          shard_id=session.shard_id, session=session,
                          timeout=timeout)
        self._finish(rc, timeout + 0.5)

    # -- stats-backed placement probes ------------------------------------
    def _stats(self, *, max_age: Optional[float] = None):
        age = self._stats_max_age if max_age is None else max_age
        rows = self._stats_rows
        if rows is not None and time.monotonic() - self._stats_t < age:
            return rows
        rc = self._submit(RPC_OP_STATS, flags=RPC_STATS_READ_PATHS,
                          timeout=self._stats_timeout)
        result = self._finish(rc, self._stats_timeout + 0.5)
        nhid, raft, rows, read_paths = decode_rpc_stats(result.data)
        with self._lock:
            self._stats_nhid = nhid
            self._stats_raft = raft
            self._stats_rows = rows
            self._stats_read_paths = read_paths
            self._stats_t = time.monotonic()
        return rows

    def read_path_counts(self) -> Dict[str, int]:
        """The remote's per-path read serve counts (empty against a
        pre-readplane server — the section is flag-gated)."""
        try:
            self._stats()
        except (RequestError, OSError):
            pass
        return dict(self._stats_read_paths)

    def balance_shard_stats(self) -> list:
        # the Collector's feed: always a fresh snapshot (its own cadence
        # IS the staleness bound it wants)
        return self._stats(max_age=0.0)

    def _row(self, shard_id: int) -> dict:
        for row in self._stats():
            if row["shard_id"] == shard_id:
                return row
        raise ShardNotFound(f"shard {shard_id} not on {self.address}")

    def _get_node(self, shard_id: int):
        # placement probe only (gateway _host_for any_ok sweep): raises
        # ShardNotFound when the remote doesn't carry the shard
        return self._row(shard_id)

    def get_leader_id(self, shard_id: int):
        row = self._row(shard_id)
        lid = row["leader_id"]
        return lid, lid != 0

    def is_leader_of(self, shard_id: int) -> bool:
        try:
            row = self._row(shard_id)
        except (RequestError, OSError):
            return False
        return row["leader_id"] != 0 and row["leader_id"] == row["replica_id"]

    def raft_address(self) -> str:
        if not self._stats_raft:
            try:
                self._stats()
            except (RequestError, OSError):
                return ""
        return self._stats_raft

    # -- event taps (host-side planes; nothing to tap remotely) -----------
    def add_event_tap(self, tap) -> None:
        return None

    def remove_event_tap(self, tap) -> None:
        return None

    # -- fleet-scope telemetry (obs/fleetscope.py) -------------------------
    def obs_query(self, what: str, *, cursor: int = 0, epoch: int = 0,
                  limit: int = 256, timeout: float = 2.0) -> dict:
        """One fleet-scope query against the remote (``RPC_OP_OBS``).
        ``what``: metrics | recorder | spans.  Returns the decoded
        reply dict annotated with ``bytes`` (the reply payload size,
        the scope's overhead counter).  Raises :class:`ObsUnsupported`
        against a pre-obs server (the collector marks it no-obs)."""
        flags = {
            "metrics": RPC_OBS_METRICS,
            "recorder": RPC_OBS_RECORDER,
            "spans": RPC_OBS_SPANS,
        }[what]
        rc = self._submit(
            RPC_OP_OBS, flags=flags, timeout=timeout,
            payload=encode_obs_query(cursor=cursor, epoch=epoch,
                                     limit=limit),
        )
        try:
            result = self._finish(rc, timeout + 0.5)
        except RequestError as e:
            if "unknown op" in str(e):
                raise ObsUnsupported(str(e))
            raise
        reply = decode_obs_reply(result.data)
        reply["bytes"] = len(result.data)
        return reply

    # -- nemesis plane (scenario harness only) -----------------------------
    def send_fault(self, action: str, *, fault: Optional[dict] = None,
                   timeout: float = 2.0) -> None:
        """Drive the REMOTE host's FaultController (RPC_OP_FAULT must be
        enabled server-side).  ``action``: activate | heal_wire |
        heal_all; ``fault``: Fault fields for activate."""
        spec = {"action": action}
        if fault is not None:
            spec["fault"] = fault
        rc = self._submit(
            RPC_OP_FAULT, timeout=timeout,
            payload=json.dumps(spec).encode("utf-8"),
        )
        self._finish(rc, timeout + 0.5)


# ---------------------------------------------------------------------------
# gossip-fed routing
# ---------------------------------------------------------------------------
class RouteFeeder:
    """Periodic Collector sweep feeding the gateway's RoutingCache.

    In-proc gateways learn routes from host event taps; remote handles
    have no taps, so this loop is the multi-process fleet's routing
    plane: every ``interval`` it snapshots gossip liveness, collects
    ``balance_shard_stats`` over the live handles (one STATS RPC per
    host) and bulk-refreshes the routing table from the view's
    ``leader_map`` — then drops any cached route pointing at a host
    the view no longer contains (``refresh_from_view`` merges, it
    never removes; a dead leader's stale route would otherwise pin
    until a proposal bounced off it)."""

    def __init__(self, gateway, gossip=None, *, interval: float = 0.25):
        from ..balance.view import Collector

        self._gw = gateway
        self._gossip = gossip
        self._interval = interval
        self._alive_ids: set = set()
        self._collector = Collector(alive=self._host_alive)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.ticks = 0

    def _host_alive(self, key: str, nh) -> bool:
        if nh is None or getattr(nh, "_closed", False):
            return False
        if self._gossip is None:
            return True
        nhid = getattr(nh, "nodehost_id", "")
        # unknown identity (no STATS exchange yet): let the collect
        # attempt itself decide — its failure marks the host dead for
        # this round and the breaker darkens it for the next
        return not nhid or nhid in self._alive_ids

    def tick(self) -> None:
        """One sweep (the loop body; callable directly from tests)."""
        if self._gossip is not None:
            self._alive_ids = set(self._gossip.alive_peers())
        view = self._collector.collect(self._gw._live_hosts())
        routes = self._gw.routes
        routes.refresh_from_view(view)
        live = set(view.hosts)
        for sid, key in routes.table().items():
            if key not in live:
                routes.invalidate(sid)
        self.ticks += 1

    def start(self) -> None:
        t = threading.Thread(
            target=self._main, daemon=True, name="tpu-route-feeder"
        )
        self._thread = t
        t.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def _main(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — feeder must outlive any
                # one flaky collect; routes just stay stale one round
                _log.exception("route feeder tick failed")
