"""Gossip registry: NodeHostID -> RaftAddress resolution over UDP.

reference: internal/registry gossip mode (hashicorp/memberlist
propagating NodeHostID->RaftAddress so replicas can move hosts) [U].
This is a push-gossip epidemic: every interval each node sends its full
(id, address, version) table to up to ``fanout`` random known peers
plus the configured seeds; receivers merge by per-origin version.  The
table is tiny (one row per nodehost), so full-state push keeps the
protocol trivially convergent without anti-entropy digests.

``GossipRegistry`` wraps the static (shard, replica) -> value registry:
when the stored value is a NodeHostID the gossip table translates it to
the host's current raft address at resolve time.
"""
from __future__ import annotations

import random
import socket
import struct
import threading
from io import BytesIO
from typing import Dict, List, Optional, Tuple

from ..id import is_nodehost_id
from ..logger import get_logger
from ..pb import MASK64
from .registry import Registry
from .tcp import parse_address

_log = get_logger("registry")

_MAGIC = 0x47535052  # "GSPR"
_u32 = struct.Struct("<I")
_u64 = struct.Struct("<Q")

MAX_PACKET = 60 * 1024
MAX_ROWS = 4096  # per-packet row cap, enforced symmetrically encode/decode
# per-string bound (ids are ~36B uuids, addrs host:port): keeps any single
# accepted row far below MAX_PACKET so _encode_packets' per-packet size
# invariant can't be broken by a hostile row that got merged into the table
MAX_ROW_STR = 512


def _encode_row(nhid: str, addr: str, ver: int) -> bytes:
    b = BytesIO()
    for s in (nhid, addr):
        raw = s.encode("utf-8")
        b.write(_u32.pack(len(raw)))
        b.write(raw)
    b.write(_u64.pack(ver & MASK64))
    return b.getvalue()


def _encode_packets(
    table: Dict[str, Tuple[str, int]], sender: str, sender_id: str = ""
) -> List[bytes]:
    """Shard the full table into UDP-safe packets (each under MAX_PACKET
    and under the decoder's 4096-row cap).  Every packet carries the
    ``__sender__`` row so receivers learn the peer address from any
    fragment, plus the ``__sender_id__`` row (the origin's NodeHostID)
    so receivers can track per-host liveness from DIRECT contact — a
    relayed row about X says nothing about X being alive; a packet FROM
    X does.  Merge is per-row, so fragments need no reassembly."""
    meta_rows = [_encode_row("__sender__", sender, 0)]
    if sender_id:
        meta_rows.append(_encode_row("__sender_id__", sender_id, 0))
    meta_size = sum(len(r) for r in meta_rows)
    rows: List[List[bytes]] = [list(meta_rows)]
    size = 8 + meta_size
    for nhid, (addr, ver) in table.items():
        if len(nhid.encode()) > MAX_ROW_STR or len(addr.encode()) > MAX_ROW_STR:
            continue  # decoder would reject it anyway; don't waste a packet
        rb = _encode_row(nhid, addr, ver)
        if size + len(rb) > MAX_PACKET or len(rows[-1]) >= MAX_ROWS:
            rows.append(list(meta_rows))
            size = 8 + meta_size
        rows[-1].append(rb)
        size += len(rb)
    return [
        _u32.pack(_MAGIC) + _u32.pack(len(chunk)) + b"".join(chunk)
        for chunk in rows
    ]


def _decode_table(data: bytes) -> Optional[Dict[str, Tuple[str, int]]]:
    try:
        pos = 0

        def take(n):
            nonlocal pos
            if pos + n > len(data):
                raise ValueError("short")
            out = data[pos : pos + n]
            pos += n
            return out

        if _u32.unpack(take(4))[0] != _MAGIC:
            return None
        count = _u32.unpack(take(4))[0]
        if count > MAX_ROWS:
            return None
        table = {}
        for _ in range(count):
            n1 = _u32.unpack(take(4))[0]
            if n1 > MAX_ROW_STR:
                return None
            nhid = take(n1).decode("utf-8")
            n2 = _u32.unpack(take(4))[0]
            if n2 > MAX_ROW_STR:
                return None
            addr = take(n2).decode("utf-8")
            ver = _u64.unpack(take(8))[0]
            table[nhid] = (addr, ver)
        return table
    except (ValueError, UnicodeDecodeError, struct.error):
        return None


# consecutive direct packets a suspect peer must deliver before it
# counts alive again (see GossipManager._suspect)
SUSPECT_CLEAR_PACKETS = 3


class GossipManager:
    """The UDP push-gossip epidemic itself."""

    def __init__(
        self,
        nodehost_id: str,
        raft_address: str,
        bind_address: str,
        seeds: List[str],
        advertise_address: str = "",
        interval: float = 0.2,
        fanout: int = 3,
    ):
        self.nodehost_id = nodehost_id
        self.raft_address = raft_address
        self.bind_address = bind_address
        self.advertise_address = advertise_address
        self.seeds = list(seeds)
        self.interval = interval
        self.fanout = fanout
        self._lock = threading.Lock()
        # nodehost_id -> (raft_address, version)
        self._table: Dict[str, Tuple[str, int]] = {nodehost_id: (raft_address, 1)}
        # gossip peer addresses we have heard from (for fanout selection)
        self._peers: set = set(seeds)
        # nodehost_id -> monotonic instant of last DIRECT packet from it
        # (liveness for the balance control plane; relayed rows don't
        # count — see _encode_packets)
        self._last_heard: Dict[str, float] = {}
        # suspect hysteresis (docs/BALANCE.md, one-way partitions): a
        # peer that ever misses its liveness window is SUSPECT and must
        # deliver SUSPECT_CLEAR_PACKETS consecutive direct packets
        # before it reads alive again.  Under an intermittent
        # asym_drop toward us (p < 1) the occasional lucky packet
        # refreshes _last_heard sporadically — without the counter the
        # peer's liveness would oscillate at the window boundary and
        # the balance repair invariant would churn its replicas.
        # nodehost_id -> direct packets heard since marked suspect
        self._suspect: Dict[str, int] = {}
        self._sock: Optional[socket.socket] = None
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._send_err_logged = False

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        host, port = parse_address(self.bind_address)
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, port))
        s.settimeout(0.2)
        self._sock = s
        self.bind_address = f"{host}:{s.getsockname()[1]}"
        if not self.advertise_address:
            self.advertise_address = self.bind_address
        for fn, name in (
            (self._recv_main, "gossip-recv"),
            (self._push_main, "gossip-push"),
        ):
            t = threading.Thread(target=fn, daemon=True, name=f"tpu-raft-{name}")
            t.start()
            self._threads.append(t)

    def close(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=1.0)
        if self._sock is not None:
            self._sock.close()

    # -- api -------------------------------------------------------------
    def set_raft_address(self, addr: str) -> None:
        """Advertise a new raft address (host moved)."""
        with self._lock:
            _, ver = self._table[self.nodehost_id]
            self._table[self.nodehost_id] = (addr, ver + 1)
            self.raft_address = addr

    def lookup(self, nodehost_id: str) -> Optional[str]:
        with self._lock:
            rec = self._table.get(nodehost_id)
            return rec[0] if rec else None

    def table(self) -> Dict[str, str]:
        with self._lock:
            return {k: v[0] for k, v in self._table.items()}

    def last_heard(self, nodehost_id: str) -> Optional[float]:
        """Monotonic instant of the last packet received directly from
        the host, or None if never heard (self counts as now)."""
        import time as _time

        if nodehost_id == self.nodehost_id:
            return _time.monotonic()
        with self._lock:
            return self._last_heard.get(nodehost_id)

    def alive_peers(self, window: Optional[float] = None) -> set:
        """NodeHostIDs heard from directly within ``window`` seconds
        (always includes self).  The balance collector's liveness
        signal when hosts span processes.

        The default window scales with fleet size: each push round
        targets only ``fanout`` random peers (plus the seeds), so with
        N hosts the expected gap between DIRECT contacts from a given
        live peer is ~``interval * N / fanout`` — a fixed small window
        would mark live hosts dead at moderate fleet sizes and the
        balance repair invariant would churn their replicas.  Pass an
        explicit window only with that math in mind."""
        import time as _time

        if window is None:
            with self._lock:
                n = max(len(self._table), 1)
            window = max(2.0, self.interval * 5.0 * n / max(self.fanout, 1))
        cutoff = _time.monotonic() - window
        with self._lock:
            alive = set()
            for k, t in self._last_heard.items():
                if t < cutoff:
                    # missed the window: suspect from here on — reset
                    # the recovery counter even if already suspect
                    self._suspect[k] = 0
                    continue
                if k in self._suspect:
                    # fresh but still suspect: one lucky packet through
                    # an intermittent one-way drop is not recovery
                    continue
                alive.add(k)
        alive.add(self.nodehost_id)
        return alive

    # -- internals -------------------------------------------------------
    def _merge(self, table: Dict[str, Tuple[str, int]], sender,
               sender_id: Optional[str] = None) -> None:
        import time as _time

        with self._lock:
            if sender_id:
                self._last_heard[sender_id] = _time.monotonic()
                if sender_id in self._suspect:
                    self._suspect[sender_id] += 1
                    if self._suspect[sender_id] >= SUSPECT_CLEAR_PACKETS:
                        del self._suspect[sender_id]
            for nhid, (addr, ver) in table.items():
                if nhid == self.nodehost_id:
                    # never accept a peer's view of OUR address: after a
                    # restart peers gossip the old address at a higher
                    # version; refute it by re-asserting ours above it
                    cur_addr, cur_ver = self._table[nhid]
                    if ver >= cur_ver and addr != cur_addr:
                        self._table[nhid] = (cur_addr, ver + 1)
                    continue
                cur = self._table.get(nhid)
                if cur is None or ver > cur[1]:
                    self._table[nhid] = (addr, ver)
            if sender:
                self._peers.add(sender)

    def _recv_main(self) -> None:
        while not self._stop.is_set():
            try:
                data, addr = self._sock.recvfrom(MAX_PACKET)
            except socket.timeout:
                continue
            except OSError:
                return
            table = _decode_table(data)
            if table is None:
                continue
            # the packet's meta rows carry the sender's gossip addr and
            # NodeHostID (the liveness signal)
            sender = table.pop("__sender__", None)
            sender_id = table.pop("__sender_id__", None)
            self._merge(
                table,
                sender[0] if sender else None,
                sender_id[0] if sender_id else None,
            )

    def _push_main(self) -> None:
        while not self._stop.is_set():
            self._stop.wait(self.interval)
            if self._stop.is_set():
                return
            with self._lock:
                table = dict(self._table)
                peers = list(self._peers)
            pkts = _encode_packets(table, self.advertise_address, self.nodehost_id)
            random.shuffle(peers)
            targets = peers[: self.fanout]
            for seed in self.seeds:
                if seed not in targets:
                    targets.append(seed)
            for t in targets:
                if t == self.advertise_address:
                    continue
                for pkt in pkts:
                    try:
                        self._sock.sendto(pkt, parse_address(t))
                    except OSError as e:
                        if not self._send_err_logged:
                            self._send_err_logged = True
                            _log.warning(
                                "gossip sendto %s failed (%s); "
                                "further send errors suppressed", t, e
                            )


class GossipRegistry(Registry):
    """(shard, replica) -> address registry that resolves NodeHostIDs
    through the gossip table (reference: INodeRegistry gossip mode [U])."""

    def __init__(self, manager: GossipManager):
        super().__init__()
        self.manager = manager

    def resolve(self, shard_id: int, replica_id: int) -> Optional[str]:
        v = super().resolve(shard_id, replica_id)
        if v is not None and is_nodehost_id(v):
            return self.manager.lookup(v)
        return v
