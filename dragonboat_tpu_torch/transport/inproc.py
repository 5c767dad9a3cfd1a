"""In-process loopback transport.

reference: the chan-based test transports in internal/transport [U].
Multiple NodeHosts in one process register by address in a module-level
network table; delivery is a direct call into the receiver's handler
(which only enqueues — cheap and deadlock-free).  Fault injection goes
through the unified ``fault_injector`` hook protocol
(faults.FaultController.on_wire): partitions, drop/delay/duplicate/
reorder and chunk corruption, shared with the TCP transport.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

from ..pb import Chunk, MessageBatch
from ..raftio import (
    ChunkHandler,
    IConnection,
    ISnapshotConnection,
    ITransport,
    MessageHandler,
)

_network_lock = threading.Lock()
_network: Dict[str, "InProcTransport"] = {}


def reset_inproc_network() -> None:
    with _network_lock:
        _network.clear()


class _InProcConnection(IConnection):
    def __init__(self, owner: "InProcTransport", target: str):
        self.owner = owner
        self.target = target

    def close(self) -> None:
        pass

    def send_message_batch(self, batch: MessageBatch) -> None:
        with _network_lock:
            peer = _network.get(self.target)
        if peer is None or peer._closed:
            raise ConnectionError(f"no transport at {self.target}")
        inj = self.owner.fault_injector
        if inj is None:
            peer.deliver(batch)
            return
        src = self.owner.fault_source or self.owner.address
        for b in inj.on_wire(src, self.target, batch):
            peer.deliver(b)


class _InProcSnapshotConnection(ISnapshotConnection):
    def __init__(self, owner: "InProcTransport", target: str):
        self.owner = owner
        self.target = target

    def close(self) -> None:
        pass

    def query_resume(self, probe: Chunk) -> int:
        """Resume-cursor query (ChunkSink.resume_cursor on the peer):
        direct call — the in-proc analogue of the TCP resume frames."""
        with _network_lock:
            peer = _network.get(self.target)
        if peer is None or peer._closed or peer.resume_handler is None:
            return 0
        return peer.resume_handler(probe)

    def send_chunk(self, chunk: Chunk) -> None:
        with _network_lock:
            peer = _network.get(self.target)
        if peer is None or peer._closed:
            raise ConnectionError(f"no transport at {self.target}")
        inj = self.owner.fault_injector
        if inj is None:
            chunks = (chunk,)
        else:
            src = self.owner.fault_source or self.owner.address
            chunks = inj.on_wire(src, self.target, chunk)
        for c in chunks:
            if not peer.deliver_chunk(c):
                raise ConnectionError(f"chunk rejected by {self.target}")
        if not chunks:
            # chunks ride a RELIABLE stream: a swallowed chunk must fail
            # the send (a real network stalls/breaks the stream) — a
            # silent success here would wedge the sender's raft peer in
            # SNAPSHOT state forever, since the receiver's reassembly
            # never completes and no status is ever reported
            raise ConnectionError("nemesis: snapshot chunk lost")


class InProcTransport(ITransport):
    def __init__(
        self,
        address: str,
        message_handler: MessageHandler,
        chunk_handler: Optional[ChunkHandler] = None,
    ):
        self.address = address
        self.message_handler = message_handler
        self.chunk_handler = chunk_handler
        self._closed = False
        # the unified fault plane (faults.FaultController.on_wire)
        self.fault_injector = None
        # resume-cursor query target (ChunkSink.resume_cursor); set by
        # the NodeHost beside chunk_handler
        self.resume_handler = None

    def name(self) -> str:
        return "inproc"

    def start(self) -> None:
        with _network_lock:
            _network[self.address] = self

    def close(self) -> None:
        self._closed = True
        with _network_lock:
            if _network.get(self.address) is self:
                del _network[self.address]

    def get_connection(self, target: str) -> IConnection:
        return _InProcConnection(self, target)

    def get_snapshot_connection(self, target: str) -> ISnapshotConnection:
        return _InProcSnapshotConnection(self, target)

    def deliver(self, batch: MessageBatch) -> None:
        if not self._closed:
            self.message_handler(batch)

    def deliver_chunk(self, chunk: Chunk) -> bool:
        if self._closed or self.chunk_handler is None:
            return False
        return self.chunk_handler(chunk)
