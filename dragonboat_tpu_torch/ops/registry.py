"""Registry of every device program of the port and the kernels it launches.

The counterpart of the reference's program registry: the same 21 names
(19 single-device programs, 2 on a groups mesh), each with

* ``fn`` — the port's callable: on CUDA tensors it launches its hand
  written kernels (or raises), on CPU tensors it runs the plain version;
* ``plain`` — the plain PyTorch version of the same program, on any
  device (the parity contract: ``fn`` and ``plain`` agree bit for bit);
* ``build`` — numpy canonical inputs at the distinct sizes of ``CANON``
  (``materialize`` puts them on a device as the port's tensors): the
  reference's, fresh rows and empty inboxes, on which a program does
  little of its arithmetic — they check that the entry runs and which
  kernels it launches;
* ``live`` — seeded live inputs of the same shapes (``live_world``): 21
  three-replica groups stepped through elections, proposals and
  replication, inboxes over every hot message type, live route tables,
  a mix of alive and dead rows — the ones a parity check holds;
* ``bindings`` — the entry points of ``csrc/bindings.cpp`` the callable
  reaches on CUDA;
* ``donate`` / ``g_last`` — the reference's declarations, value for value
  (its ``donate_argnums`` and its internal-layout flag), which
  ``analysis/devicecheck.py`` holds the port to: a donated operand whose
  leaf has an output of the same shape and dtype is returned in the
  operand's own storage, and a G-last program keeps G as the trailing
  axis.

``GLOBALS`` names, for every ``m.def`` of the bindings, the
``__global__`` functions it launches (the kernel it counts as is
``_native.ENTRIES``'s).  ``unregistered_kernels`` scans the sources: a
binding or a ``__global__`` that no entry reaches is a finding, so a new kernel
cannot land without a registered program (the reference's
``unregistered-jit`` rule, for CUDA).

Nothing here builds or launches a kernel at import.
"""
from __future__ import annotations

import functools
import re
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import _native
from . import colocated as C
from . import colocated_ref
from . import engine as E
from . import engine_ref
from . import kernel as K
from . import kernel_ref
from . import route as R
from . import route_ref
from .convert import state_to_internal, inbox_to_internal
from .fuzz import fuzz_inbox_np, padded_cluster_np, route_np
from .placement import GroupsMesh
from .types import (
    N_VALS,
    DeviceOut,
    DeviceState,
    Inbox,
    make_inbox,
    make_out,
    make_state,
)

CSRC = Path(__file__).resolve().parent.parent / "csrc"

# canonical geometry, every size distinct (the reference's): PB = P*budget
# is the colocated routed-region width, M_ASM = M + PB the assembled one
CANON = dict(G=64, P=3, W=8, M=5, E=2, O=8, budget=2)
CANON["PB"] = CANON["P"] * CANON["budget"]
CANON["M_ASM"] = CANON["M"] + CANON["PB"]
# routed_round's inbox width satisfies base + P*budget == M
M_ROUTE = CANON["M_ASM"]
BASE_ROUTE = M_ROUTE - CANON["PB"]

# m.def name -> the __global__ functions it launches
GLOBALS: Dict[str, Tuple[str, ...]] = {
    "raft_step": ("raft_step_kernel",),
    "raft_step_routed": ("raft_step_kernel",),
    "raft_step_internal": ("raft_step_internal_kernel",),
    "summarize_flags": ("summarize_flags_kernel",),
    "gather_pack": ("gather_pack_kernel",),
    "place_rows": ("place_rows_kernel",),
    "set_remote_snapshot": ("place_snapshot_kernel",),
    "merge_escalated": ("merge_escalated_kernel",),
    "route": ("route_walk_kernel", "route_recv_kernel"),
    "assemble_inbox": ("inbox_copy_kernel",),
    "host_inbox_from_ticks": ("inbox_fill_kernel",),
    "zero_inbox_rows": ("inbox_copy_kernel",),
    "select_and_blob": ("select_count_kernel", "select_scan_kernel",
                        "select_write_kernel"),
    "xlane_pack": ("xlane_count_kernel", "xlane_scan_kernel",
                   "xlane_write_kernel"),
    "xlane_scatter": ("xlane_scatter_kernel",),
}


class Host(NamedTuple):
    """An operand the program takes as a host numpy array (a mask the
    engine builds on the host), left as it is by ``materialize``."""

    value: np.ndarray


class EntryPoint(NamedTuple):
    name: str
    fn: Callable
    plain: Callable
    build: Callable[[], Tuple[tuple, dict]]
    bindings: Tuple[str, ...]
    live: Callable[[int], Tuple[tuple, dict]]
    donate: Tuple[int, ...] = ()
    g_last: bool = False

    def kernels(self) -> Tuple[str, ...]:
        return tuple(dict.fromkeys(_native.ENTRIES[b] for b in self.bindings))


# -- numpy canonical inputs --------------------------------------------
def _np(tree):
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    return type(tree)(*(_np(t) for t in tree))


def _g() -> int:
    return CANON["G"]


def _state(rows: Optional[int] = None) -> DeviceState:
    return _np(make_state(rows or _g(), CANON["P"], CANON["W"],
                          device="cpu"))


def _inbox(M: int, rows: Optional[int] = None) -> Inbox:
    return _np(make_inbox(rows or _g(), M, CANON["E"], device="cpu"))


def _out(M: int) -> DeviceOut:
    return _np(make_out(_g(), CANON["P"], M, CANON["E"], CANON["O"],
                        device="cpu"))


def _combo() -> np.ndarray:
    return np.zeros((_g(), 4), np.int32)


def _idx(n: int) -> np.ndarray:
    return np.zeros((n,), np.int32)


def _idx4(b: int) -> np.ndarray:
    return np.zeros((4, b), np.int32)


def _tables() -> Tuple[np.ndarray, np.ndarray]:
    return (np.full((_g(), CANON["P"]), -1, np.int32),
            np.zeros((_g(), CANON["P"]), np.int32))


def _b_step():
    return (_state(), _inbox(CANON["M"])), dict(out_capacity=CANON["O"])


def _b_step_internal():
    st = _np(state_to_internal(make_state(_g(), CANON["P"], CANON["W"],
                                          device="cpu")))
    ib = _np(inbox_to_internal(make_inbox(_g(), CANON["M"], CANON["E"],
                                          device="cpu")))
    return (st, ib), dict(out_capacity=CANON["O"])


def _b_scatter_rows():
    return (_state(), np.full((_g(),), -1, np.int32), _state(4)), {}


def _b_select_rows():
    return (Host(np.zeros((_g(),), bool)), _state(), _state()), {}


def _b_gather_rows():
    return (_state(), _idx(4)), {}


def _b_summarize_flags():
    return (_state(), _state(), _out(CANON["M"])), {}


def _b_gather_vals():
    return (_state(), _out(CANON["M"]), _idx(4)), {}


def _b_gather_detail():
    return (_state(), _out(CANON["M"]), _idx4(4)), {}


def _b_gather_detail_vals():
    return (_state(), _out(CANON["M"]), _idx4(4), _idx(4)), {}


def _b_set_remote_snapshot():
    return (_state(), _idx(1), _idx(1), _idx(1)), {}


def _b_assemble_inbox():
    combo = _combo()
    combo[:, 0] = 1  # the alive lane (the reference's all-true mask)
    return (_inbox(CANON["M"]), _inbox(CANON["PB"]), combo), {}


def _b_assemble_and_step():
    return (_state(), _inbox(CANON["M"]), _inbox(CANON["PB"]), _combo()), \
        dict(out_capacity=CANON["O"])


def _b_route_step():
    dest, rank = _tables()
    return (_state(), _state(), _out(CANON["M_ASM"]), dest, rank,
            _combo()), dict(PB=CANON["PB"], E=CANON["E"],
                            budget=CANON["budget"])


def _b_select_and_blob():
    G = _g()
    nwords = (CANON["O"] + 31) // 32
    return (_state(), _out(CANON["M_ASM"]), np.zeros((6,), np.int32),
            np.zeros((G, nwords), np.int32), np.zeros((G,), np.int32),
            _combo()), dict(CAP_B=16, CAP_SL=G, CAP_N=8, CAP_A=G, CAP_S=G,
                            HOST_OFF=CANON["PB"])


def _b_zero_inbox_rows():
    return (_inbox(CANON["M_ASM"]), np.zeros((_g(),), bool)), {}


def _b_host_inbox_from_ticks():
    return (_combo(),), dict(M=CANON["M"], E=CANON["E"])


def _b_scatter_inbox_rows():
    return (_inbox(CANON["M"]), np.full((_g(),), -1, np.int32),
            _inbox(CANON["M"], 4)), {}


def _b_routed_round():
    dest, rank = _tables()
    return (_state(), _inbox(M_ROUTE), dest, rank), dict(
        out_capacity=CANON["O"], budget=CANON["budget"], base=BASE_ROUTE,
        propose_leaders=True)


def _b_fused_rounds():
    args, kw = _b_routed_round()
    return args, dict(kw, rounds=2)


# -- seeded live inputs ------------------------------------------------
LIVE_ROUNDS = 24  # plain steps from fresh rows to the live world


def _cp(tree):
    if isinstance(tree, np.ndarray):
        return tree.copy()
    return type(tree)(*(_cp(t) for t in tree))


def _rows(tree, idx):
    return type(tree)(*(a[idx].copy() for a in tree))


def _cols(tree) -> dict:
    return {k: v.numpy() for k, v in tree._asdict().items()}


@functools.lru_cache(maxsize=None)
def live_tables() -> Tuple[np.ndarray, np.ndarray]:
    """(dest, rank) of the live world's rows (their layout is the same
    for every seed)."""
    c = CANON
    cols = padded_cluster_np(c["G"], c["P"], c["W"], 0)
    return R.build_route_tables(cols["shard_id"], cols["replica_id"],
                                cols["peer_id"])


@functools.lru_cache(maxsize=8)
def live_world(seed: int) -> Dict[str, tuple]:
    """Numpy trees of a live world at ``CANON`` for ``seed`` (builders
    copy them out): the first 63 rows are 21 three-replica groups, the
    last an empty row; ``state`` is where ``LIVE_ROUNDS`` plain steps on
    routed inboxes (ticks, the groups' traffic, proposals) left them;
    ``fuzz_*`` are inboxes over every hot message type near each row's
    state at widths M, PB and M_ASM; ``host`` (width M) and ``routed``
    (width M_ASM) are routed inboxes; ``new_M``/``out_M`` and
    ``new_A``/``out_A`` the plain step of ``state`` on ``fuzz_M`` and
    ``routed``; ``combo`` has 80% of rows alive and random batch,
    proposal and tick lanes; ``merged``/``stats``/``packed``/``flags``
    are the plain route step's on ``out_A``."""
    c = CANON
    G, P, W, M, E, O = (c[k] for k in ("G", "P", "W", "M", "E", "O"))
    MA, PB = c["M_ASM"], c["PB"]
    rng = np.random.default_rng(seed)
    st = _tensors(DeviceState(**padded_cluster_np(G, P, W, seed)))
    out = make_out(G, P, M, E, O, device="cpu")
    for _ in range(LIVE_ROUNDS):
        ib = route_np(_cols(st), _cols(out), rng, M, E)
        st, out = kernel_ref.step(st, _tensors(Inbox(**ib)), O)
    cols = _cols(st)
    w = dict(state=_np(st))
    w["fuzz_M"] = Inbox(**fuzz_inbox_np(cols, rng, M, E))
    w["fuzz_PB"] = Inbox(**fuzz_inbox_np(cols, rng, PB, E))
    w["fuzz_A"] = Inbox(**fuzz_inbox_np(cols, rng, MA, E))
    w["host"] = Inbox(**route_np(cols, _cols(out), rng, M, E))
    w["routed"] = Inbox(**route_np(cols, _cols(out), rng, MA, E))
    for k, ib in (("M", "fuzz_M"), ("A", "routed")):
        new, o = kernel_ref.step(st, _tensors(w[ib]), O)
        w[f"new_{k}"], w[f"out_{k}"] = _np(new), _np(o)
    combo = np.stack([rng.random(G) < 0.8, rng.random(G) < 0.3,
                      rng.random(G) < 0.2, rng.integers(0, 3, G)], axis=1)
    w["combo"] = combo.astype(np.int32)
    dest, rank = live_tables()
    merged, _regions, stats, packed, flags = colocated_ref.route_step(
        st, _tensors(w["new_A"]), _tensors(w["out_A"]),
        torch.from_numpy(dest), torch.from_numpy(rank),
        torch.from_numpy(w["combo"]), PB=PB, E=E, budget=c["budget"])
    w["merged"] = _np(merged)
    w["stats"], w["packed"], w["flags"] = (
        t.numpy() for t in (stats, packed, flags))
    return w


def _live(seed: int, salt: int):
    """(the live world's copy, a generator for the builder's own draws)."""
    return live_world(seed), np.random.default_rng([seed, salt])


def _pos(r, G: int, n: int) -> np.ndarray:
    """A [G] position map: half the rows take one of ``n`` sub rows."""
    return np.where(r.random(G) < 0.5, r.integers(0, n, G),
                    -1).astype(np.int32)


def _l_step(seed):
    w, _ = _live(seed, 0)
    return (_cp(w["state"]), _cp(w["fuzz_M"])), dict(out_capacity=CANON["O"])


def _l_step_internal(seed):
    w, _ = _live(seed, 1)
    return (_np(state_to_internal(_tensors(w["state"]))),
            _np(inbox_to_internal(_tensors(w["fuzz_M"])))), dict(
        out_capacity=CANON["O"])


def _l_scatter_rows(seed):
    w, r = _live(seed, 2)
    return (_cp(w["state"]), _pos(r, _g(), 4),
            _rows(w["new_M"], r.choice(_g(), 4, replace=False))), {}


def _l_select_rows(seed):
    w, r = _live(seed, 3)
    return (Host(r.random(_g()) < 0.5), _cp(w["state"]),
            _cp(w["new_M"])), {}


def _l_gather_rows(seed):
    w, r = _live(seed, 4)
    return (_cp(w["state"]), r.integers(0, _g(), 4).astype(np.int32)), {}


def _l_summarize_flags(seed):
    w, _ = _live(seed, 5)
    return (_cp(w["state"]), _cp(w["new_M"]), _cp(w["out_M"])), {}


def _l_idx(r, *shape) -> np.ndarray:
    return r.integers(0, _g(), shape).astype(np.int32)


def _l_gather_vals(seed):
    w, r = _live(seed, 6)
    return (_cp(w["new_M"]), _cp(w["out_M"]), _l_idx(r, 4)), {}


def _l_gather_detail(seed):
    w, r = _live(seed, 7)
    return (_cp(w["new_M"]), _cp(w["out_M"]), _l_idx(r, 4, 4)), {}


def _l_gather_detail_vals(seed):
    w, r = _live(seed, 8)
    return (_cp(w["new_M"]), _cp(w["out_M"]), _l_idx(r, 4, 4),
            _l_idx(r, 4)), {}


def _l_set_remote_snapshot(seed):
    w, r = _live(seed, 9)
    return (_cp(w["state"]), _l_idx(r, 1),
            r.integers(0, CANON["P"], 1).astype(np.int32),
            r.integers(1, 100, 1).astype(np.int32)), {}


def _l_assemble_inbox(seed):
    w, _ = _live(seed, 10)
    return (_cp(w["host"]), _cp(w["fuzz_PB"]), w["combo"].copy()), {}


def _l_assemble_and_step(seed):
    w, _ = _live(seed, 11)
    return (_cp(w["state"]), _cp(w["host"]), _cp(w["fuzz_PB"]),
            w["combo"].copy()), dict(out_capacity=CANON["O"])


def _l_route_step(seed):
    w, _ = _live(seed, 12)
    dest, rank = live_tables()
    return (_cp(w["state"]), _cp(w["new_A"]), _cp(w["out_A"]), dest.copy(),
            rank.copy(), w["combo"].copy()), dict(
        PB=CANON["PB"], E=CANON["E"], budget=CANON["budget"])


def _l_select_and_blob(seed):
    w, _ = _live(seed, 13)
    _args, kw = _b_select_and_blob()
    return (_cp(w["merged"]), _cp(w["out_A"]), w["stats"].copy(),
            w["packed"].copy(), w["flags"].copy(), w["combo"].copy()), kw


def _l_zero_inbox_rows(seed):
    w, r = _live(seed, 14)
    return (_cp(w["routed"]), r.random(_g()) < 0.4), {}


def _l_host_inbox_from_ticks(seed):
    w, _ = _live(seed, 15)
    return (w["combo"].copy(),), dict(M=CANON["M"], E=CANON["E"])


def _l_scatter_inbox_rows(seed):
    w, r = _live(seed, 16)
    return (_cp(w["host"]), _pos(r, _g(), 4),
            _rows(w["fuzz_M"], r.choice(_g(), 4, replace=False))), {}


def _l_routed_round(seed):
    w, _ = _live(seed, 17)
    dest, rank = live_tables()
    _args, kw = _b_routed_round()
    return (_cp(w["state"]), _cp(w["fuzz_A"]), dest.copy(), rank.copy()), kw


def _l_fused_rounds(seed):
    args, kw = _l_routed_round(seed)
    return args, dict(kw, rounds=2)


# -- plain versions with the port callables' signatures ----------------
def _plain_gather_vals(state, out, idx):
    return engine_ref.gather_pack(state, out, None, idx).reshape(-1, N_VALS)


def _plain_gather_detail(state, out, idx4):
    return engine_ref.gather_pack(state, out, idx4, None).reshape(
        idx4.shape[1], -1)


def _plain_gather_detail_vals(state, out, idx4, idx_sum):
    return engine_ref.gather_pack(state, out, idx4, idx_sum)


def _plain_summarize_flags(old, new, out):
    return engine_ref.summarize_flags(old, new, out)


def _plain_routed_round(*args, **kw):
    st, ib, stats, n_esc = route_ref.routed_round(*args, **kw)
    return st, ib, R.RouteStats(*stats), n_esc


def _with_plain_moves(fn):
    def plain(*args, **kw):
        return fn(*args, impl=engine_ref, **kw)

    return plain


ENTRY_POINTS: Tuple[EntryPoint, ...] = (
    EntryPoint("kernel.step", K.step, kernel_ref.step, _b_step,
               ("raft_step",),
               _l_step),
    EntryPoint("kernel.step_internal", K.step_internal,
               kernel_ref.step_internal, _b_step_internal,
               ("raft_step_internal",),
               _l_step_internal, g_last=True),
    EntryPoint("engine._scatter_rows", E._scatter_rows,
               _with_plain_moves(E._scatter_rows), _b_scatter_rows,
               ("place_rows",),
               _l_scatter_rows),
    EntryPoint("engine._select_rows", E._select_rows,
               _with_plain_moves(E._select_rows), _b_select_rows,
               ("place_rows",),
               _l_select_rows),
    EntryPoint("engine._gather_rows", E._gather_rows,
               _with_plain_moves(E._gather_rows), _b_gather_rows,
               ("place_rows",),
               _l_gather_rows),
    EntryPoint("engine._summarize_flags", E._summarize_flags,
               _plain_summarize_flags, _b_summarize_flags,
               ("summarize_flags",),
               _l_summarize_flags),
    EntryPoint("engine._gather_vals", E._gather_vals, _plain_gather_vals,
               _b_gather_vals, ("gather_pack",),
               _l_gather_vals),
    EntryPoint("engine._gather_detail", E._gather_detail,
               _plain_gather_detail, _b_gather_detail, ("gather_pack",),
               _l_gather_detail),
    EntryPoint("engine._gather_detail_vals", E._gather_detail_vals,
               _plain_gather_detail_vals, _b_gather_detail_vals,
               ("gather_pack",),
               _l_gather_detail_vals),
    EntryPoint("engine._set_remote_snapshot", E._set_remote_snapshot,
               _with_plain_moves(E._set_remote_snapshot),
               _b_set_remote_snapshot, ("set_remote_snapshot",),
               _l_set_remote_snapshot),
    EntryPoint("colocated._assemble_inbox", C._assemble_inbox,
               colocated_ref.assemble_inbox, _b_assemble_inbox,
               ("assemble_inbox",),
               _l_assemble_inbox),
    EntryPoint("colocated._assemble_and_step", C._assemble_and_step,
               colocated_ref.assemble_and_step, _b_assemble_and_step,
               ("assemble_inbox", "raft_step"),
               _l_assemble_and_step, donate=(1, 2)),
    EntryPoint("colocated._route_step", C._route_step,
               colocated_ref.route_step, _b_route_step,
               ("merge_escalated", "route", "summarize_flags"),
               _l_route_step, donate=(1,)),
    EntryPoint("colocated._select_and_blob", C._select_and_blob,
               colocated_ref.select_and_blob, _b_select_and_blob,
               ("select_and_blob", "gather_pack"),
               _l_select_and_blob),
    EntryPoint("colocated._zero_inbox_rows", C._zero_inbox_rows,
               colocated_ref.zero_inbox_rows, _b_zero_inbox_rows,
               ("zero_inbox_rows",),
               _l_zero_inbox_rows),
    EntryPoint("colocated._host_inbox_from_ticks", C._host_inbox_from_ticks,
               colocated_ref.host_inbox_from_ticks, _b_host_inbox_from_ticks,
               ("host_inbox_from_ticks",),
               _l_host_inbox_from_ticks),
    EntryPoint("colocated._scatter_inbox_rows", C._scatter_inbox_rows,
               colocated_ref.scatter_inbox_rows, _b_scatter_inbox_rows,
               ("place_rows",),
               _l_scatter_inbox_rows),
    EntryPoint("route.routed_round", R.routed_round, _plain_routed_round,
               _b_routed_round,
               ("raft_step_routed", "merge_escalated", "route"),
               _l_routed_round),
    EntryPoint("route.fused_rounds", R.fused_rounds, route_ref.fused_rounds,
               _b_fused_rounds,
               ("raft_step_routed", "merge_escalated", "route"),
               _l_fused_rounds),
)


# the bindings the two mesh programs reach (``mesh_entry_points``)
MESH_BINDINGS: Dict[str, Tuple[str, ...]] = {
    "kernel.step_sharded": ("raft_step",),
    "route.sharded_round": ("raft_step", "merge_escalated", "route",
                            "xlane_pack", "xlane_scatter"),
}


def mesh_entry_points(mesh: GroupsMesh) -> Tuple[EntryPoint, ...]:
    """The two programs of the sharded plane over ``mesh``: each returns
    its state (and output or inbox) joined into global trees, and its
    plain version is the single-device program on the same global rows
    (``kernel_ref.step``; ``route_ref.routed_round`` over the global
    tables ``dest_dev * rows_per_block + dest_local``).  ``CANON['G']``
    must divide the mesh (64 covers 1-8 blocks).  The live round runs on
    the live world's tables cut into the blocks, whose groups straddle
    block edges; its lane budget covers their worst edge."""
    G, P = CANON["G"], CANON["P"]
    if G % mesh.size:
        raise ValueError(f"CANON G={G} must divide mesh size {mesh.size}")
    per = G // mesh.size
    live = R.split_route_tables(*live_tables(), mesh.size)
    step_sharded = K.make_step_sharded(
        mesh, _tensors(_state()), _tensors(_inbox(CANON["M"])),
        out_capacity=CANON["O"])
    round_sharded = R.make_sharded_round(
        mesh, M=M_ROUTE, E=CANON["E"], out_capacity=CANON["O"],
        budget=CANON["budget"],
        xbudget=max(4, R.xbudget_for(live, CANON["budget"], mesh.size)),
        base=BASE_ROUTE, propose_leaders=True)

    def b_step_sharded():
        return (_state(), _inbox(CANON["M"])), {}

    def b_round_sharded():
        # strided tables: every block has cross-block edges
        dl = np.zeros((G, P), np.int32)
        dd = (np.arange(G)[:, None] % mesh.size
              * np.ones((1, P), np.int64)).astype(np.int32)
        return (_state(), _inbox(M_ROUTE), dl, dd,
                np.zeros((G, P), np.int32)), {}

    def l_step_sharded(seed):
        args, _kw = _l_step(seed)
        return args, {}

    def l_round_sharded(seed):
        (st, ib, _dest, rank), _kw = _l_routed_round(seed)
        return (st, ib, live.dest_local.copy(), live.dest_dev.copy(),
                rank), {}

    def step_fn(st, ib):
        return tuple(mesh.join(t) for t in step_sharded(st, ib))

    def step_plain(st, ib):
        return kernel_ref.step(st, ib, CANON["O"])

    def round_fn(st, ib, dl, dd, rk):
        st2, ib2, _rs, _ls = round_sharded(st, ib, dl, dd, rk)
        return mesh.join(st2), mesh.join(ib2)

    def round_plain(st, ib, dl, dd, rk):
        dest = torch.where(dl >= 0, dd * per + dl, -1).to(torch.int32)
        st2, ib2, _rs, _n = route_ref.routed_round(
            st, ib, dest, rk, out_capacity=CANON["O"],
            budget=CANON["budget"], base=BASE_ROUTE, propose_leaders=True)
        return st2, ib2

    return (
        EntryPoint("kernel.step_sharded", step_fn, step_plain,
                   b_step_sharded, MESH_BINDINGS["kernel.step_sharded"],
                   l_step_sharded),
        EntryPoint("route.sharded_round", round_fn, round_plain,
                   b_round_sharded, MESH_BINDINGS["route.sharded_round"],
                   l_round_sharded),
    )


# -- running entries ------------------------------------------------------
def _tensors(tree, device="cpu"):
    if isinstance(tree, Host):
        return tree.value
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(tree)).to(device)
    return type(tree)(*(_tensors(t, device) for t in tree))


def materialize(args: tuple, device) -> tuple:
    """The builder's numpy operands as the port's tensors on ``device``
    (``Host`` operands stay numpy).  ``run`` builds fresh operands for
    every call, since a program may update one in place."""
    return tuple(_tensors(a, device) for a in args)


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a program's result, in order (NamedTuples and
    tuples flattened)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for x in tree for t in leaves(x)]


def run(ep: EntryPoint, device, *, plain: bool = False,
        seed: Optional[int] = None):
    """``ep`` (or its plain version) on fresh canonical inputs on
    ``device`` (with ``seed``: fresh live inputs of ``live_world(seed)``);
    the result's tensors."""
    args, kw = ep.build() if seed is None else ep.live(seed)
    fn = ep.plain if plain else ep.fn
    return leaves(fn(*materialize(args, device), **kw))


def all_entry_points(mesh: Optional[GroupsMesh] = None
                     ) -> Tuple[EntryPoint, ...]:
    """The 19 single-device entries, and with ``mesh`` the 2 mesh ones."""
    return ENTRY_POINTS + (mesh_entry_points(mesh) if mesh else ())


def entry(name: str, mesh: Optional[GroupsMesh] = None) -> EntryPoint:
    for ep in all_entry_points(mesh):
        if ep.name == name:
            return ep
    raise KeyError(name)


def kernels_of(names) -> Tuple[str, ...]:
    """The kernels (``_native.LAUNCHES`` keys) the entries ``names``
    launch on CUDA, in first-use order (mesh entries included)."""
    binds = [b for n in names for b in (
        MESH_BINDINGS[n] if n in MESH_BINDINGS else entry(n).bindings)]
    return tuple(dict.fromkeys(_native.ENTRIES[b] for b in binds))


def _reached_bindings() -> Tuple[str, ...]:
    bs = [b for ep in ENTRY_POINTS for b in ep.bindings]
    bs += [b for v in MESH_BINDINGS.values() for b in v]
    return tuple(dict.fromkeys(bs))


def kernels() -> Tuple[str, ...]:
    """Every kernel a registered program launches, in first-use order."""
    return tuple(dict.fromkeys(_native.ENTRIES[b]
                               for b in _reached_bindings()))


# -- the unregistered-kernel scan ------------------------------------------
_MDEF = re.compile(r'\bm\.def\(\s*"(\w+)"')
_GLOBAL = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)"
                     r"\s*)?(?:void\s+)?(\w+)\s*\(")


def scan_sources(csrc: Path = CSRC) -> Tuple[List[str], List[str]]:
    """(the ``m.def`` names of ``bindings.cpp``, the ``__global__``
    functions of every ``.cu`` / ``.cuh`` file) under ``csrc``."""
    csrc = Path(csrc)
    defs = _MDEF.findall((csrc / "bindings.cpp").read_text())
    globs: List[str] = []
    for f in sorted(csrc.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            globs += _GLOBAL.findall(f.read_text())
    return defs, globs


def unregistered_kernels(csrc: Path = CSRC) -> List[str]:
    """Findings: every binding and every ``__global__`` under ``csrc``
    must be reached by a registered entry (through ``GLOBALS``), and
    every bound entry point must have its kernel in ``_native.ENTRIES``.
    Empty when the registry covers the sources."""
    defs, globs = scan_sources(csrc)
    reached = set(_reached_bindings())
    findings = []
    for d in defs:
        if d not in GLOBALS or d not in _native.ENTRIES:
            findings.append(f"unregistered-binding: m.def {d!r} is not "
                            "in GLOBALS and _native.ENTRIES")
        elif d not in reached:
            findings.append(f"unreached-binding: no entry reaches {d!r}")
    for b in dict.fromkeys([*GLOBALS, *_native.ENTRIES]):
        if b not in defs:
            findings.append(f"stale-binding: {b!r} has no m.def")
    covered = {g for b in reached if b in GLOBALS for g in GLOBALS[b]}
    named = {g for gs in GLOBALS.values() for g in gs}
    for g in globs:
        if g not in named:
            findings.append(f"unregistered-kernel: __global__ {g!r} is "
                            "launched by no binding in GLOBALS")
        elif g not in covered:
            findings.append(f"unreached-kernel: no entry reaches {g!r}")
    for g in sorted(named - set(globs)):
        findings.append(f"stale-kernel: {g!r} is not a __global__ under "
                        "csrc/")
    return findings
