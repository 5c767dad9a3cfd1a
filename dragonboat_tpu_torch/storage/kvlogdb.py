"""ShardedKVLogDB: the classic key-encoded LogDB over a general KV.

reference: internal/logdb/ (logdb.go, db.go, batched.go, plain.go,
cache.go, kv/kv.go) [U] — the pebble-backed default of v3: raft records
key-encoded into an ordered KV, N internal sub-stores partitioned by
shard id for lock/fsync parallelism, one atomic fsynced write batch per
``save_raft_state``, an entry read cache, and BOTH entry codecs:

  * ``plain``   — one entry per key (simple, larger key count)
  * ``batched`` — runs of entries packed per record, keyed at the run's
                  base index (the reference's 'hard' batched mode)

The KV itself (storage/kvstore.py) is journal+checkpoint based and runs
over the vfs layer, so the power-loss fuzz applies to this backend too.
"""
from __future__ import annotations

import struct
import threading
from collections import OrderedDict
from io import BytesIO
from typing import Dict, List, Optional, Tuple

from ..pb import MASK64, Bootstrap, Entry, Snapshot, State, Update
from ..raftio import ILogDB, NodeInfo, RaftState
from ..transport.wire import (
    _R,
    WireError,
    _r_entry,
    _r_snapshot,
    _w_entry,
    _w_snapshot,
)
from .kvstore import KVStore, WriteBatch
from .vfs import IVFS

K_STATE = 0x01
K_ENTRY = 0x02
K_BOOTSTRAP = 0x03
K_SNAPSHOT = 0x04
K_MININDEX = 0x05

_pair = struct.Struct(">BQQ")       # kind, shard, replica (big-endian sorts)
_entry_key = struct.Struct(">BQQQ")  # kind, shard, replica, index

MAX_INDEX = (1 << 63) - 1
DEFAULT_BATCH_SIZE = 64
DEFAULT_STORES = 4
CACHE_RECORDS = 512


def _pk(kind: int, shard_id: int, replica_id: int) -> bytes:
    return _pair.pack(kind, shard_id & MASK64, replica_id & MASK64)


def _ek(shard_id: int, replica_id: int, index: int) -> bytes:
    return _entry_key.pack(
        K_ENTRY, shard_id & MASK64, replica_id & MASK64, index & MASK64
    )


def _enc_entries(entries: List[Entry]) -> bytes:
    b = BytesIO()
    b.write(struct.pack("<I", len(entries)))
    for e in entries:
        _w_entry(b, e)
    return b.getvalue()


def _dec_entries(data: bytes) -> List[Entry]:
    r = _R(data)
    return [_r_entry(r) for _ in range(r.count())]


def _enc_state(st: State) -> bytes:
    return struct.pack(
        "<QQQ", st.term & MASK64, st.vote & MASK64, st.commit & MASK64
    )


def _dec_state(data: bytes) -> State:
    if len(data) != 24:
        raise WireError(f"state record must be 24 bytes, got {len(data)}")
    t, v, c = struct.unpack("<QQQ", data)
    return State(term=t, vote=v, commit=c)


def _enc_bootstrap(bs: Bootstrap) -> bytes:
    b = BytesIO()
    b.write(struct.pack("<I", len(bs.addresses)))
    for rid in sorted(bs.addresses):
        b.write(struct.pack("<Q", rid & MASK64))
        raw = bs.addresses[rid].encode("utf-8")
        b.write(struct.pack("<I", len(raw)))
        b.write(raw)
    b.write(struct.pack("<B", int(bs.join)))
    return b.getvalue()


def _dec_bootstrap(data: bytes) -> Bootstrap:
    r = _R(data)
    addresses = {r.u64(): r.s() for _ in range(r.count())}
    return Bootstrap(addresses=addresses, join=bool(r.u8()))


class ShardedKVLogDB(ILogDB):
    """ILogDB over N KVStore sub-stores, partitioned by shard id."""

    def __init__(
        self,
        directory: str,
        *,
        stores: int = DEFAULT_STORES,
        batched: bool = True,
        batch_size: int = DEFAULT_BATCH_SIZE,
        fs: Optional[IVFS] = None,
        max_journal_bytes: int = 32 * 1024 * 1024,
        gc_segments: int = 3,
    ):
        self.dir = directory
        self.batched = batched
        self.batch_size = batch_size if batched else 1
        self._stores = [
            KVStore(
                f"{directory}/store-{i:02d}",
                fs=fs,
                max_journal_bytes=max_journal_bytes,
                gc_segments=gc_segments,
            )
            for i in range(stores)
        ]
        # only the cache/version dicts need a lock: KVStore.commit is
        # internally atomic, and the engine guarantees per-shard
        # single-writer stepping (reference keeps per-sub-store locks;
        # a global write lock would serialize the sub-stores' fsyncs)
        self._cache_lock = threading.Lock()
        # decoded-record read cache, invalidated by a per-pair version
        # (reference: internal/logdb/cache.go [U])
        self._cache: "OrderedDict[tuple, List[Entry]]" = OrderedDict()
        self._versions: Dict[Tuple[int, int], int] = {}

    def _store(self, shard_id: int) -> KVStore:
        return self._stores[shard_id % len(self._stores)]

    def _bump(self, shard_id: int, replica_id: int) -> None:
        with self._cache_lock:
            k = (shard_id, replica_id)
            self._versions[k] = self._versions.get(k, 0) + 1

    def _ver(self, shard_id: int, replica_id: int) -> int:
        with self._cache_lock:
            return self._versions.get((shard_id, replica_id), 0)

    # -- ILogDB ----------------------------------------------------------
    def name(self) -> str:
        return "sharded-kv" + ("-batched" if self.batched else "-plain")

    def close(self) -> None:
        for s in self._stores:
            s.close()

    def list_node_info(self) -> List[NodeInfo]:
        out = []
        for s in self._stores:
            lo = struct.pack(">B", K_STATE)
            hi = struct.pack(">B", K_STATE + 1)
            for k, _ in s.iterate(lo, hi):
                _, shard_id, replica_id = _pair.unpack(k)
                out.append(NodeInfo(shard_id=shard_id, replica_id=replica_id))
        return sorted(out, key=lambda n: (n.shard_id, n.replica_id))

    def save_bootstrap_info(self, shard_id, replica_id, bootstrap) -> None:
        wb = WriteBatch()
        wb.put(_pk(K_BOOTSTRAP, shard_id, replica_id), _enc_bootstrap(bootstrap))
        # a bootstrap also registers the node (reference stores a state
        # record so ListNodeInfo finds never-started replicas [U?])
        st = self._store(shard_id)
        if st.get(_pk(K_STATE, shard_id, replica_id)) is None:
            wb.put(_pk(K_STATE, shard_id, replica_id), _enc_state(State()))
        st.commit(wb)

    def get_bootstrap_info(self, shard_id, replica_id):
        raw = self._store(shard_id).get(_pk(K_BOOTSTRAP, shard_id, replica_id))
        return _dec_bootstrap(raw) if raw is not None else None

    def save_raft_state(self, updates: List[Update], worker_id: int) -> None:
        """Atomic, durable, ONE fsync per sub-store touched — updates for
        different raft shards landing in the same sub-store share it
        (reference: cross-shard WriteBatch batching [U])."""
        batches: Dict[int, WriteBatch] = {}
        for u in updates:
            idx = (u.shard_id % len(self._stores))
            wb = batches.setdefault(idx, WriteBatch())
            self._encode_update(self._stores[idx], wb, u)
        for idx, wb in batches.items():
            self._stores[idx].commit(wb)
        for u in updates:
            # invalidate AFTER the commit: bumping first would let a
            # concurrent reader cache pre-commit bytes under the new
            # version and serve a replaced suffix forever
            self._bump(u.shard_id, u.replica_id)

    def _encode_update(self, store: KVStore, wb: WriteBatch, u: Update) -> None:
        s, r = u.shard_id, u.replica_id
        if not u.state.is_empty():
            wb.put(_pk(K_STATE, s, r), _enc_state(u.state))
        elif store.get(_pk(K_STATE, s, r)) is None:
            wb.put(_pk(K_STATE, s, r), _enc_state(State()))
        ents = u.entries_to_save
        if ents:
            first = ents[0].index
            # conflicting-suffix overwrite: drop every record that could
            # hold an entry >= first (batched records are keyed at their
            # base, so start the wipe one batch earlier)
            wipe_from = max(0, first - self.batch_size + 1)
            wb.delete_range(_ek(s, r, wipe_from), _ek(s, r, MAX_INDEX))
            # ...but re-save the prefix of the straddling batch (direct
            # record scan — NOT _read_entries, whose contiguity-from-low
            # contract returns nothing when `wipe_from` predates the log)
            if self.batched and wipe_from < first:
                keep = [
                    e
                    for _, v in store.iterate(
                        _ek(s, r, wipe_from), _ek(s, r, first)
                    )
                    for e in _dec_entries(v)
                    if e.index < first
                ]
                for i in range(0, len(keep), self.batch_size):
                    run = keep[i : i + self.batch_size]
                    wb.put(_ek(s, r, run[0].index), _enc_entries(run))
            for i in range(0, len(ents), self.batch_size):
                run = ents[i : i + self.batch_size]
                wb.put(_ek(s, r, run[0].index), _enc_entries(list(run)))
        if not u.snapshot.is_empty():
            b = BytesIO()
            _w_snapshot(b, u.snapshot)
            wb.put(_pk(K_SNAPSHOT, s, r), b.getvalue())

    # -- reads -----------------------------------------------------------
    def _read_entries(
        self, shard_id, replica_id, low, high, max_size=1 << 62
    ) -> List[Entry]:
        """Contiguous entries in [low, high) starting at low."""
        if high <= low:
            return []
        store = self._store(shard_id)
        scan_lo = _ek(shard_id, replica_id, max(0, low - self.batch_size + 1))
        scan_hi = _ek(shard_id, replica_id, high)
        ver = self._ver(shard_id, replica_id)
        out: List[Entry] = []
        size = 0
        nxt = low
        for k, v in store.iterate(scan_lo, scan_hi):
            ck = (k, ver)
            with self._cache_lock:
                ents = self._cache.get(ck)
                if ents is not None:
                    self._cache.move_to_end(ck)
            if ents is None:
                ents = _dec_entries(v)
                with self._cache_lock:
                    self._cache[ck] = ents
                    if len(self._cache) > CACHE_RECORDS:
                        self._cache.popitem(last=False)
            for e in ents:
                if e.index < nxt:
                    continue
                if e.index != nxt or e.index >= high:
                    return out  # gap (or past the window): stop
                size += e.size_bytes()
                if out and size > max_size:
                    return out
                out.append(e)
                nxt += 1
        return out

    def read_raft_state(self, shard_id, replica_id, last_index) -> Optional[RaftState]:
        store = self._store(shard_id)
        raw = store.get(_pk(K_STATE, shard_id, replica_id))
        if raw is None:
            return None
        ss = self.get_snapshot(shard_id, replica_id)
        min_raw = store.get(_pk(K_MININDEX, shard_id, replica_id))
        min_index = struct.unpack("<Q", min_raw)[0] if min_raw else 1
        first = max(min_index, ss.index + 1)
        # contiguous count from the record headers ALONE (each record's
        # <I count prefix + its base index in the key) — no body decode,
        # no read-cache thrash at startup for a large log
        count = 0
        nxt = first
        scan_lo = _ek(shard_id, replica_id,
                      max(0, first - self.batch_size + 1))
        for k, v in store.iterate(scan_lo, _ek(shard_id, replica_id, MAX_INDEX)):
            base = _entry_key.unpack(k)[3]
            (n,) = struct.unpack_from("<I", v, 0)
            if base > nxt:
                break  # gap
            if base + n <= nxt:
                continue  # fully below first (straddling prefix record)
            count += base + n - nxt
            nxt = base + n
        return RaftState(
            state=_dec_state(raw), first_index=first, entry_count=count
        )

    def iterate_entries(self, shard_id, replica_id, low, high, max_size):
        return self._read_entries(shard_id, replica_id, low, high, max_size)

    def term(self, shard_id, replica_id, index) -> Optional[int]:
        ents = self._read_entries(shard_id, replica_id, index, index + 1)
        if ents:
            return ents[0].term
        ss = self.get_snapshot(shard_id, replica_id)
        if ss.index == index and index > 0:
            return ss.term
        return None

    # -- compaction ------------------------------------------------------
    def remove_entries_to(self, shard_id, replica_id, index) -> None:
        store = self._store(shard_id)
        # the straddling batched record keeps its tail (direct record
        # scan — see the straddle note in _encode_update)
        keep: List[Entry] = []
        if self.batched:
            keep = [
                e
                for _, v in store.iterate(
                    _ek(shard_id, replica_id,
                        max(0, index - self.batch_size + 1)),
                    _ek(shard_id, replica_id, index + 1),
                )
                for e in _dec_entries(v)
                if e.index > index
            ]
        wb = WriteBatch()
        wb.delete_range(
            _ek(shard_id, replica_id, 0), _ek(shard_id, replica_id, index + 1)
        )
        for i in range(0, len(keep), self.batch_size):
            run = keep[i : i + self.batch_size]
            wb.put(_ek(shard_id, replica_id, run[0].index), _enc_entries(run))
        wb.put(
            _pk(K_MININDEX, shard_id, replica_id),
            struct.pack("<Q", (index + 1) & MASK64),
        )
        store.commit(wb, sync=False)  # advisory, like the tan path
        self._bump(shard_id, replica_id)  # invalidate AFTER the commit

    def compact_entries_to(self, shard_id, replica_id, index) -> None:
        self.remove_entries_to(shard_id, replica_id, index)

    # -- snapshots / membership -----------------------------------------
    def save_snapshots(self, updates: List[Update]) -> None:
        batches: Dict[int, WriteBatch] = {}
        for u in updates:
            if u.snapshot.is_empty():
                continue
            cur = self.get_snapshot(u.shard_id, u.replica_id)
            if u.snapshot.index <= cur.index:
                continue
            b = BytesIO()
            _w_snapshot(b, u.snapshot)
            idx = u.shard_id % len(self._stores)
            wb = batches.setdefault(idx, WriteBatch())
            wb.put(_pk(K_SNAPSHOT, u.shard_id, u.replica_id), b.getvalue())
        for idx, wb in batches.items():
            self._stores[idx].commit(wb)

    def get_snapshot(self, shard_id, replica_id) -> Snapshot:
        raw = self._store(shard_id).get(_pk(K_SNAPSHOT, shard_id, replica_id))
        if raw is None:
            return Snapshot()
        return _r_snapshot(_R(raw))

    def remove_node_data(self, shard_id, replica_id) -> None:
        wb = WriteBatch()
        for kind in (K_STATE, K_BOOTSTRAP, K_SNAPSHOT, K_MININDEX):
            wb.delete(_pk(kind, shard_id, replica_id))
        wb.delete_range(
            _ek(shard_id, replica_id, 0), _ek(shard_id, replica_id, MAX_INDEX)
        )
        self._store(shard_id).commit(wb)
        self._bump(shard_id, replica_id)  # invalidate AFTER the commit

    def import_snapshot(self, snapshot: Snapshot, replica_id: int) -> None:
        s = snapshot.shard_id
        wb = WriteBatch()
        b = BytesIO()
        _w_snapshot(b, snapshot)
        wb.put(_pk(K_SNAPSHOT, s, replica_id), b.getvalue())
        wb.put(
            _pk(K_STATE, s, replica_id),
            _enc_state(
                State(term=snapshot.term, vote=0, commit=snapshot.index)
            ),
        )
        wb.delete_range(
            _ek(s, replica_id, 0), _ek(s, replica_id, MAX_INDEX)
        )
        wb.put(
            _pk(K_MININDEX, s, replica_id),
            struct.pack("<Q", (snapshot.index + 1) & MASK64),
        )
        self._store(s).commit(wb)
        self._bump(s, replica_id)  # invalidate AFTER the commit


def kv_logdb_factory(config, **kw):
    """NodeHostConfig.expert.logdb_factory hook (classic KV backend)."""
    import os

    base = config.wal_dir or config.nodehost_dir
    return ShardedKVLogDB(os.path.join(base, "kvlogdb"), **kw)
