"""The engines' ``mesh=`` modes against the reference's, on the CPU.

``TorchStepEngine(mesh=...)`` and ``ColocatedEngineGroup(mesh=...)`` on
``GroupsMesh(["cpu"] * D)`` (the kernels' plain versions, block by
block) against the reference's ``VectorStepEngine(mesh=...)`` and
``ColocatedEngineGroup(mesh=...)`` on ``Mesh(jax.devices("cpu")[:D],
("groups",))``.  Tolerance: zero everywhere; inputs are int32, made from
numpy seeds.

* Programs: at D = 1, 2 and 4 a colocated launch through the engine's
  per-block path — assemble and step, the route step with the lane
  between blocks, select and blob, the blocks' heads and details read as
  one — against the reference's ``_assemble_and_step``, ``_route_step``
  and ``_select_and_blob`` on the same global rows, over fused waves of 3
  rounds on a layout whose shards straddle blocks, with dead receivers,
  escalated senders, more messages than the budget, REPLICATE below the
  ring and (one case) a partition cut across blocks.
* The colocated pack: ``route_ref.lane_pack`` with the alive lane, the
  delivered bits and the undelivered words after each block's local
  route equals the reference ``route`` with ``dest_alive`` on the global
  rows (bits, undelivered words, RouteStats with the lane folded in);
  the kernel's row logic compiled as host C++ agrees with it.
* Placement: the free lists, ``device_coordinate`` and
  ``device_chip_count`` of both engines equal the reference's after the
  same attaches and detaches.
* Clusters: NodeHost clusters on the mesh engines apply the same
  commands as the reference's mesh engines, with the parity self-check
  armed; the colocated engine's lane slices and coordinates (the port of
  ``test_updatelanes.py::test_sharded_mesh_lane_slices``); a layout whose
  shards must straddle blocks carries lane traffic with no lane drop,
  and every route step of its run, replayed through the reference's
  ``_route_step`` on the jax mesh, gives the routed counters the engine
  reports.
* A one-device mesh is the single-device engine, bit for bit; a
  capacity that does not divide, a mixed mesh and a CUDA mesh without a
  card raise.
"""
from __future__ import annotations

import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

import test_route as TR
from dragonboat_tpu.ops import colocated as JC
from dragonboat_tpu.ops import route as JR
from dragonboat_tpu.ops import sync as JS
from dragonboat_tpu.ops import types as JT
from dragonboat_tpu_torch.ops import colocated as PC
from dragonboat_tpu_torch.ops import route as PR
from dragonboat_tpu_torch.ops import route_ref
from dragonboat_tpu_torch.ops.engine import TorchStepEngine
from dragonboat_tpu_torch.ops.placement import GroupsMesh, Sharded
from test_torch_colocated_ops import assert_same, to_np, to_port

P, W, E, O, B = 5, 32, 4, 32, 4
PB = P * B
MH = 8
SEED = 20261021


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_mesh(D):
    devs = [d for d in jax.devices() if d.platform == "cpu"]
    if len(devs) < D:
        pytest.skip(f"needs {D} host devices, have {len(devs)}")
    return Mesh(np.asarray(devs[:D]), ("groups",))


def on_jax_mesh(tree, mesh):
    """A numpy tree (to_np's form) as jax arrays sharded over the groups
    axis of ``mesh`` — the reference's mesh mode."""
    rows = NamedSharding(mesh, PartitionSpec("groups"))

    def put(x):
        if isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], str):
            name, fields = x
            typ = {"DeviceState": JT.DeviceState, "Inbox": JT.Inbox,
                   "DeviceOut": JT.DeviceOut}[name]
            return typ(**{k: put(v) for k, v in fields.items()})
        if isinstance(x, tuple):
            return tuple(put(y) for y in x)
        return jax.device_put(jnp.asarray(x), rows)

    return put(tree)


def join(core, tree):
    """A Sharded tree of the engine as one global numpy tree (to_np's
    form)."""
    if isinstance(tree, Sharded):
        parts = tree.parts
        if isinstance(parts[0], torch.Tensor):
            return core._blocks.numpy(parts)
        return (type(parts[0]).__name__, {
            f: core._blocks.numpy([getattr(p, f) for p in parts])
            for f in parts[0]._fields})
    return to_np(tree)


# --------------------------------------------------------------------------
# programs: one launch through the per-block path against the reference
# --------------------------------------------------------------------------
# 16 rows; a block of 4 (D = 4) or 8 (D = 2) rows never holds every
# replica of shards 1 and 3
LAYOUT = {1: [1, 2, 3], 2: [1, 2, 3], 3: [1, 2, 3, 4, 5], 4: [1, 2, 3],
          5: [1, 2]}


def _layout():
    rafts, _rows = TR.make_cluster_rafts(LAYOUT)
    st = to_np(JS.state_from_rafts(rafts, P, W))
    dest, rank = TR.tables_for(rafts)
    shards = np.array([r.shard_id for r in rafts])
    replicas = np.array([r.replica_id for r in rafts])
    return st, np.asarray(dest), np.asarray(rank), shards, replicas


def _fuzz_out(out_np, st_np, rng, esc_share=0.1):
    """The step's outbox with seeded extra messages after each row's own:
    toward the row's peers (straddling blocks), several to one peer (past
    the budget), forwarded PROPOSE, REPLICATE below the ring window, an
    unknown id; and a share of the rows escalated."""
    buf = out_np[1]["buf"].copy()
    count = out_np[1]["count"].copy()
    G = buf.shape[0]
    peers = st_np[1]["peer_id"]
    last, first = st_np[1]["last_index"], st_np[1]["first_index"]
    types_ = [JT.MT_HEARTBEAT, JT.MT_HEARTBEAT_RESP, JT.MT_REPLICATE,
              JT.MT_REPLICATE_RESP, JT.MT_REQUEST_VOTE_RESP, JT.MT_PROPOSE]
    for g in range(G):
        ids = [int(x) for x in peers[g] if x]
        # half the rows send a burst toward one peer (past the budget)
        burst = int(rng.choice(ids)) if rng.random() < 0.5 else 0
        for o in range(int(count[g]), min(O, int(count[g]) + 8)):
            if rng.random() < 0.15:
                break
            mt = int(rng.choice(types_))
            to = (burst or int(rng.choice(ids))) if rng.random() < 0.9 else 9
            n = int(rng.integers(1, E + 1)) if mt == JT.MT_REPLICATE else 0
            lo = max(int(first[g]), int(last[g]) - (W - 1))
            li = (lo - 2 if rng.random() < 0.3 else int(last[g]) - n)
            buf[g, o] = [mt, to, int(rng.integers(1, 4)), 1, li,
                         int(last[g]), 0, 0, 0, n, 0]
            count[g] = o + 1
    out_np[1]["buf"] = buf
    out_np[1]["count"] = count
    esc = rng.random(G) < esc_share
    out_np[1]["escalate"] = np.where(esc, 1, out_np[1]["escalate"]).astype(
        np.int32)
    return out_np


def _cut(dest, shards, replicas):
    """Shard 3's replicas 1 and 3 in one partition group, 2, 4 and 5 in
    the other (the engine's cut, colocated._rebuild_tables): some of its
    links across the blocks are severed, others are not."""
    part = np.where((shards == 3) & np.isin(replicas, (1, 3)), 1, 0)
    cut = (dest >= 0) & (part[np.clip(dest, 0, len(part) - 1)]
                         != part[:, None])
    return np.where(cut, -1, dest).astype(np.int32)


def _fake_rec(core, caps, heads, details):
    return types.SimpleNamespace(
        caps=caps, t_req=0.0, heads={},
        head_dev=[[PC._Readback(h) for h in heads.parts]],
        detail_dev=[[PC._Readback(d) for d in details.parts]])


def _parse_ref(core, head, detail, caps, G):
    nw = (O + 31) // 32
    h = core._parse_head(np.asarray(head).view(np.int32), caps, G, nw)
    return h, core._parse_detail(np.asarray(detail).view(np.int32), caps)


def _assert_blobs_equal(core, got_h, got_d, want_h, want_d, caps, what):
    """The joined head and detail against the reference's: flags,
    delivered bits, route stats and counts whole; each section's
    selected rows and values (its first ``count`` rows, when the count
    fits the cap: past it the engine takes the exact gather)."""
    gf, gb, gs, gc, grows, gvals = got_h
    wf, wb, ws, wc, wrows, wvals = want_h
    assert np.array_equal(gf, wf), what
    assert np.array_equal(gb, wb), what
    assert np.array_equal(gs, ws), (what, gs, ws)
    assert np.array_equal(gc, wc), what
    keys = ("b", "sl", "n", "a", "s")
    for i, k in enumerate(keys):
        n = int(wc[i])
        if n <= caps[k]:
            assert np.array_equal(grows[i][:n], wrows[i][:n]), (what, k)
    if int(wc[4]) <= caps["s"]:
        n = int(wc[4])
        assert np.array_equal(gvals[:n], wvals[:n]), what
    for f, i in enumerate(PC._DETAIL_SECTION):
        n = int(wc[i])
        if n <= caps[keys[i]]:
            assert np.array_equal(got_d[f][:n], want_d[f][:n]), (what, f)


@pytest.mark.parametrize("D,cut", [(1, False), (2, True), (4, False)])
def test_launch_programs_match_reference_mesh(D, cut):
    st, dest, rank, shards, replicas = _layout()
    G = dest.shape[0]
    if cut:
        dest = _cut(dest, shards, replicas)
    jm = jax_mesh(D)
    core = PC.ColocatedTorchEngine(
        capacity=G, P=P, W=W, M=MH, E=E, O=O, budget=B,
        mesh=GroupsMesh(["cpu"] * D), parity_every=1)
    core._set_tables(dest, rank)
    rng = np.random.default_rng(SEED + D + 10 * cut)
    pending = to_np(JT.make_inbox(G, PB, E))
    caps = core._tier_caps(0)
    seen = dict(lane=0, esc=0, budget=0, ring=0, refused=0)
    for wave in range(3):
        combo = np.zeros((G, 4), np.int32)
        combo[:, JC._C_ALIVE] = rng.random(G) < 0.85
        combo[:, JC._C_BATCH] = rng.random(G) < 0.5
        combo[:, JC._C_PROP] = rng.random(G) < 0.2
        combo[:, JC._C_TICKS] = rng.integers(0, 4, G)
        combo_all = core._blocks.put_each(combo)
        combo_sh = Sharded(tuple(c[slice(*core._blocks.span(d))]
                                 for d, c in enumerate(combo_all)))
        for k in range(3):  # a fused wave: ticks in round 1 only
            host = to_np(JC._host_inbox_from_ticks(
                jnp.asarray(combo if k == 0 else np.zeros_like(combo)),
                M=MH, E=E))
            st_sh, host_sh, pend_sh = (core._put_rows(to_port(x))
                                       for x in (st, host, pending))
            new_sh, out_sh = core._on_blocks(
                "assemble_and_step", PC._assemble_and_step, st_sh, host_sh,
                pend_sh, combo_sh, out_capacity=O, parity=True)
            want_new, want_out = JC._assemble_and_step(
                *on_jax_mesh((st, host, pending), jm),
                jnp.asarray(combo), out_capacity=O)
            assert_same(want_new, to_port(join(core, new_sh)),
                        f"step D={D} {wave}.{k}")
            assert_same(want_out, to_port(join(core, out_sh)),
                        f"out D={D} {wave}.{k}")
            new_np = join(core, new_sh)
            out_np = _fuzz_out(join(core, out_sh), st, rng)
            seen["esc"] += int(out_np[1]["escalate"].astype(bool).sum())
            args = (st, new_np, out_np)
            want = JC._route_step(*on_jax_mesh(args, jm), jnp.asarray(dest),
                                  jnp.asarray(rank), jnp.asarray(combo),
                                  PB=PB, E=E, budget=B)
            got = core._route_blocks(
                *(core._put_rows(to_port(x)) for x in args), combo_sh,
                combo_all, parity=True)
            merged, regions, stats, packed, flags, lane = got
            for name, w, g in zip(("merged", "regions", "packed", "flags"),
                                  (want[0], want[1], want[3], want[4]),
                                  (merged, regions, packed, flags)):
                assert_same(w, to_port(join(core, g)),
                            f"{name} D={D} {wave}.{k}")
            # the blocks' blobs, read as one, against the reference's
            heads, details = core._on_blocks(
                "select_and_blob", PC._select_and_blob, merged,
                core._put_rows(to_port(out_np)), stats, packed, flags,
                combo_sh, **{f"CAP_{c.upper()}": v for c, v in
                             core._block_caps(caps).items()},
                HOST_OFF=PB, parity=True)
            lane_np = (None if lane is None else
                       sum(r.numpy().astype(np.int64) for r in lane)[None])
            rec = _fake_rec(core, caps, heads, details)
            got_h = core._round_head(rec, 0, lane_np)
            got_d = core._round_detail(rec, 0)
            wh, wd = JC._select_and_blob(
                want[0], on_jax_mesh(out_np, jm), *want[2:5],
                jnp.asarray(combo), CAP_B=caps["b"],
                CAP_SL=caps["sl"], CAP_N=caps["n"], CAP_A=caps["a"],
                CAP_S=caps["s"], HOST_OFF=PB)
            want_h, want_d = _parse_ref(core, wh, wd, caps, G)
            assert np.array_equal(want_h[2], np.asarray(want[2])), "stats"
            _assert_blobs_equal(core, got_h, got_d, want_h, want_d, caps,
                                f"blobs D={D} {wave}.{k}")
            if lane is not None:
                row = lane_np[0]
                seen["lane"] += int(row[0])
                seen["refused"] += int(row[7])
                seen["budget"] += int(row[2])
                seen["ring"] += int(row[4])
            st, pending = to_np(want[0]), to_np(want[1])
    assert seen["esc"] > 0
    if D > 1:
        # the lane carried, refused (dead receivers, PROPOSE) and dropped
        # (budget, below the ring) cross-block messages
        assert all(seen[k] > 0 for k in ("lane", "refused", "budget",
                                         "ring")), seen
        st_ = core.stats_snapshot()
        assert st_["parity_failures"] == 0
        assert st_["parity_checks_xlane_pack"] == st_[
            "parity_attempts_xlane_pack"] > 0


def test_one_block_mesh_is_the_single_device_engine():
    """A GroupsMesh of one device runs exactly the single-device engine's
    programs: after the same waves the state, the pending regions and
    every blob are bit-identical."""
    st, dest, rank, _s, _r = _layout()
    G = dest.shape[0]
    cores = [PC.ColocatedTorchEngine(capacity=G, P=P, W=W, M=MH, E=E, O=O,
                                     budget=B, **kw)
             for kw in (dict(mesh=GroupsMesh(["cpu"])), dict(device="cpu"))]
    rng = np.random.default_rng(SEED + 99)
    outs = []
    for core in cores:
        core._set_tables(dest, rank)
        core._state = core._put_rows(to_port(st))
        outs.append([])
    for wave in range(5):
        combo = np.zeros((G, 4), np.int32)
        combo[:, JC._C_ALIVE] = rng.random(G) < 0.9
        combo[:, JC._C_TICKS] = rng.integers(0, 4, G)
        for core, rec in zip(cores, outs):
            combo_all = core._blocks.put_each(combo)
            combo_sh = Sharded((combo_all[0],))
            host = core._on_blocks("host_inbox_from_ticks",
                                   PC._host_inbox_from_ticks, combo_sh,
                                   M=MH, E=E)
            new, out = core._on_blocks(
                "assemble_and_step", PC._assemble_and_step, core._state,
                host, core._pending, combo_sh, out_capacity=O)
            merged, regions, stats, packed, flags, _lane = core._route_blocks(
                core._state, new, out, combo_sh, combo_all, parity=False)
            core._state, core._pending = merged, regions
            rec.append([join(core, x) for x in (merged, regions, stats,
                                                 packed, flags)])
    assert cores[0].device_chip_count() == cores[1].device_chip_count() == 1
    for a, b in zip(*outs):
        for x, y in zip(a, b):
            assert_same(x, to_port(y), "one-block mesh")


# --------------------------------------------------------------------------
# the colocated pack against the reference route's delivered bits
# --------------------------------------------------------------------------
def _pack_inputs(rng, D):
    """test_torch_mesh's lane fuzz with every peer id once a row (a
    repeated id sums dest_dev past the mesh, which the lane drops by
    design), a ring window the route's marker rule applies to, and a
    seeded alive lane."""
    import test_torch_mesh as TM

    st, out, _ib, _tabs, sup, c = TM.lane_fuzz_inputs(rng, D, groups=8,
                                                      P=4, W=8, E=2, O=12,
                                                      B=2)
    pe = st["peer_id"].copy()
    for g in range(pe.shape[0]):
        seen_ = set()
        for p in range(pe.shape[1]):
            if pe[g, p] in seen_:
                pe[g, p] = 0
            seen_.add(int(pe[g, p]))
    st["peer_id"] = pe
    tabs = PR.build_route_tables_mesh(st["shard_id"], st["replica_id"], pe,
                                      D)
    alive = (rng.random(c["G"]) < 0.8).astype(np.int32)
    return st, out, tabs, sup, alive, c


@pytest.mark.parametrize("D", [2, 4])
def test_colocated_pack_matches_reference_route(D):
    rng = np.random.default_rng(SEED + 40 + D)
    st, out, tabs, sup, alive, c = _pack_inputs(rng, D)
    G, Pw, Ew, Ow, Bw = c["G"], c["P"], c["E"], c["O"], c["B"]
    Mw = Pw * Bw
    gl = G // D
    dest = np.where(tabs.dest_dev >= 0,
                    tabs.dest_dev * gl + tabs.dest_local, -1).astype(
                        np.int32)
    jst = JT.DeviceState(**{k: jnp.asarray(v) for k, v in st.items()})
    jout = JT.DeviceOut(**{k: jnp.asarray(v) for k, v in out.items()})
    _ib, want_stats, want_deliv = JR.route(
        jst, jout, jnp.asarray(dest), jnp.asarray(tabs.rank_in_dest),
        M=Mw, E=Ew, budget=Bw, base=0, suppress=jnp.asarray(sup),
        dest_alive=jnp.asarray(alive != 0))
    want_deliv = np.asarray(want_deliv)
    valid = np.arange(Ow)[None, :] < out["count"][:, None]
    want_und = (valid & ~want_deliv).any(axis=1).astype(np.int32)
    pst = route_ref.DeviceState(**{k: torch.from_numpy(v)
                                   for k, v in st.items()})
    pout = route_ref.DeviceOut(**{k: torch.from_numpy(v)
                                  for k, v in out.items()})
    combo = torch.zeros((G, 4), dtype=torch.int32)
    combo[:, 0] = torch.from_numpy(alive)
    total = np.zeros((8,), np.int64)
    rstats = np.zeros((6,), np.int64)
    carried = 0
    for d in range(D):
        rows = slice(d * gl, (d + 1) * gl)
        bst = route_ref.DeviceState(*(t[rows] for t in pst))
        bout = route_ref.DeviceOut(*(t[rows] for t in pout))
        bt = [torch.from_numpy(np.ascontiguousarray(t[rows]))
              for t in tabs]
        local = torch.where(bt[1] == d, bt[0], -1)
        bsup = torch.from_numpy(sup[rows].astype(np.int32))
        _r, st_l, deliv_l = route_ref.route(
            bst, bout, local, bt[2], M=Mw, E=Ew, budget=Bw, base=0,
            suppress=bsup != 0, dest_alive=combo[rows, 0] != 0)
        packed = route_ref.pack_bits(deliv_l)
        bvalid = torch.arange(Ow)[None, :] < bout.count[:, None]
        und = (bvalid & ~deliv_l).any(dim=1).to(torch.int32)
        before = packed.clone()
        _xbuf, lst = route_ref.lane_pack(
            bst, bout, *bt, me=d, n_dev=D, E=Ew, budget=Bw,
            xbudget=PR.xbudget_for(tabs, Bw, D), suppress=bsup,
            dest_alive=combo, alive_stride=4, packed=packed, undeliv=und)
        assert np.array_equal(
            route_ref.unpack_bits(packed, Ow).numpy(), want_deliv[rows]), d
        assert np.array_equal(und.numpy(), want_und[rows]), d
        carried += int((route_ref.unpack_bits(packed, Ow)
                        & ~route_ref.unpack_bits(before, Ow)).sum())
        total += lst.numpy()
        rstats += st_l.numpy()
    assert total[3] == 0 and carried == total[0] > 0 and total[7] > 0
    # the route stats folded with the lane's (colocated._round_head)
    sent, _dl, budget, _x, ring = total[:5]
    rstats[0] += sent  # delivered: every row the lane carried arrives
    rstats[1] -= sent + budget + ring + total[7]
    rstats[2] += budget
    rstats[3] += ring
    rstats[5] += total[7]
    assert np.array_equal(rstats, np.asarray(want_stats)), (rstats,
                                                            want_stats)


def test_colocated_pack_kernel_rows_match_plain_version(shim):
    """csrc/xlane.cu's pack with the colocated operands, compiled as host
    C++ and run lane by lane (``test_torch_host_step``'s shim), equals
    the plain version: lane buffer, stats row, delivered bits and
    undelivered words, every block's rows staged and none, a sized lane
    and one that drops."""
    import test_torch_host_step as HS

    from dragonboat_tpu_torch.ops import convert

    rng = np.random.default_rng(SEED + 77)
    hit = np.zeros((route_ref.N_LANE_STATS_X,), np.int64)
    for D in (2, 4):
        st, out, tabs, sup, alive, c = _pack_inputs(rng, D)
        G, Ew, Ow, Bw = c["G"], c["E"], c["O"], c["B"]
        gl = G // D
        combo = np.zeros((G, 4), np.int32)
        combo[:, 0] = alive
        sized = PR.xbudget_for(tabs, Bw, D)
        for xb, R, stage in ((sized, 32, 32 * Ow), (sized, 128, 0),
                             (max(1, sized // 8), 32, 8)):
            for me in range(D):
                rows = slice(me * gl, (me + 1) * gl)
                st_d = {k: np.ascontiguousarray(v[rows])
                        for k, v in st.items()}
                out_d = {k: np.ascontiguousarray(v[rows])
                         for k, v in out.items()}
                tabs_d = [np.ascontiguousarray(t[rows]) for t in tabs]
                packed = rng.integers(-2**31, 2**31, (gl, (Ow + 31) // 32),
                                      dtype=np.int64).astype(np.int32)
                # the route's words: its bits, and undelivered where a
                # valid message has none
                packed &= np.int32((1 << Ow) - 1) if Ow < 32 else -1
                valid = np.arange(Ow)[None, :] < out_d["count"][:, None]
                bits = route_ref.unpack_bits(torch.from_numpy(packed),
                                             Ow).numpy()
                und = (valid & ~bits).any(axis=1).astype(np.int32)
                g_pk, g_ud = packed.copy(), und.copy()
                xbuf, stats = HS.host_lane_pack(
                    shim, st_d, out_d, tabs_d, sup[rows], me=me, D=D, E=Ew,
                    B=Bw, XB=xb, R=R, stage=stage, alive=combo,
                    alive_stride=4, packed=g_pk, undeliv=g_ud)
                w_pk, w_ud = (torch.from_numpy(packed.copy()),
                              torch.from_numpy(und.copy()))
                w_xbuf, w_stats = route_ref.lane_pack(
                    convert.state_from_numpy(st_d, "cpu"),
                    convert.out_from_numpy(out_d, "cpu"),
                    *(torch.from_numpy(t) for t in tabs_d), me=me, n_dev=D,
                    E=Ew, budget=Bw, xbudget=xb,
                    suppress=torch.from_numpy(sup[rows]),
                    dest_alive=torch.from_numpy(combo), alive_stride=4,
                    packed=w_pk, undeliv=w_ud)
                what = (D, me, xb, R, stage)
                assert np.array_equal(xbuf, w_xbuf.numpy()), what
                assert np.array_equal(stats, w_stats.numpy()), what
                assert np.array_equal(g_pk, w_pk.numpy()), what
                assert np.array_equal(g_ud, w_ud.numpy()), what
                hit += stats
    assert (hit[[0, 2, 3, 4, 7]] > 0).all(), hit


# --------------------------------------------------------------------------
# placement: free lists and device coordinates against the reference
# --------------------------------------------------------------------------
class _Node:
    """What the attach path reads of a node."""

    def __init__(self, shard_id, replica_id=1):
        self.shard_id, self.replica_id = shard_id, replica_id


# attach (+) and detach (-) script: (shard, replica)
_PLACE_SCRIPT = (
    [("+", s, r) for r in (1, 2, 3) for s in (1, 2, 3)]
    + [("-", 2, 2), ("+", 4, 1), ("-", 1, 1), ("+", 4, 2), ("+", 2, 2),
       ("+", 5, 1), ("-", 3, 3), ("+", 5, 2), ("+", 1, 1)]
)


@pytest.mark.parametrize("D", [2, 4])
def test_free_lists_and_coordinates_match_reference(D, monkeypatch):
    """Both engines' free lists (striped), rows, ``device_coordinate``
    and ``device_chip_count`` equal the reference's mesh engines' after
    the same attaches and detaches (the colocated engine with its shard
    affinity).  The reference engines are built without their compile
    warm-up: nothing here runs a program."""
    from dragonboat_tpu.ops import engine as JE
    from dragonboat_tpu.storage.logdb import InMemLogDB

    monkeypatch.setattr(JE.VectorStepEngine, "_warm", lambda self: None)
    monkeypatch.setattr(JC.ColocatedVectorEngine, "_warm",
                        lambda self: None)
    jm, pm = jax_mesh(D), GroupsMesh(["cpu"] * D)
    geom = dict(capacity=16, P=P, W=W, M=8, E=E, O=O)
    base = (JE.VectorStepEngine(InMemLogDB(), **geom, mesh=jm),
            TorchStepEngine(None, **geom, mesh=pm))
    colo = (JC.ColocatedVectorEngine(**geom, budget=B, mesh=jm),
            PC.ColocatedTorchEngine(**geom, budget=B, mesh=pm))
    for ref, port in (base, colo):
        assert port._free == ref._free
        assert port.device_chip_count() == ref.device_chip_count() == D
    nodes = {}
    for op, s_, r_ in _PLACE_SCRIPT:
        if op == "+":
            node = nodes.setdefault((s_, r_), _Node(s_, r_))
            for e in colo:
                e._attach(node)
            if r_ == 1:
                for e in base:
                    e._attach(node)
        else:
            for e in colo:
                e.detach_replicas([(s_, r_)])
            if r_ == 1:
                for e in base:
                    e.detach(s_)
        for ref, port in (base, colo):
            assert port._row_of == ref._row_of, (op, s_, r_)
            assert port._free == ref._free, (op, s_, r_)
    for s_ in range(1, 7):
        assert (base[1].device_coordinate(s_)
                == base[0].device_coordinate(s_))
        for r_ in (None, 1, 2, 3):
            assert (colo[1].device_coordinate(s_, r_)
                    == colo[0].device_coordinate(s_, r_)), (s_, r_)
    # the engines really spread over the blocks
    assert len({base[1].device_coordinate(s_) for s_ in (3, 4, 5)}) > 1


# --------------------------------------------------------------------------
# clusters
# --------------------------------------------------------------------------
from test_torch_engine import (  # noqa: E402 — cluster helpers
    ADDRS,
    GEOM,
    PortKV,
    SCRIPT,
    _run_script,
    make_kv,
    shard_config,
)


def _squash(applied):
    return [c for i, c in enumerate(applied) if i == 0 or c != applied[i - 1]]


@pytest.fixture(scope="module")
def reference_mesh_run(tmp_path_factory):
    """SCRIPT on a reference cluster whose engines are
    ``VectorStepEngine(mesh=...)`` over two forced host devices: each
    replica's applied commands and state machine contents."""
    import dragonboat_tpu as ref
    from dragonboat_tpu.ops.engine import vector_step_engine_factory
    from dragonboat_tpu.storage.logdb import in_mem_logdb_factory
    from dragonboat_tpu.transport.inproc import reset_inproc_network

    class RefKV(make_kv(ref.IStateMachine)):
        @staticmethod
        def _result(n):
            return ref.Result(value=n)

    from dragonboat_tpu.ops import engine as JE

    tmp = tmp_path_factory.mktemp("ref-mesh")
    reset_inproc_network()
    # the engines compile each program at its first use instead of all
    # of them up front (the reference's warm-up only saves a stall)
    mp = pytest.MonkeyPatch()
    mp.setattr(JE.VectorStepEngine, "_warm", lambda self: None)
    nhs = {
        rid: ref.NodeHost(ref.NodeHostConfig(
            nodehost_dir=str(tmp / f"ref-{rid}"), rtt_millisecond=20,
            raft_address=ADDRS[rid],
            expert=ref.ExpertConfig(
                engine=ref.EngineConfig(exec_shards=1, apply_shards=2),
                logdb_factory=in_mem_logdb_factory,
                step_engine_factory=vector_step_engine_factory(
                    **GEOM, mesh=jax_mesh(2)),
            ),
        ))
        for rid in ADDRS
    }
    try:
        for rid, nh in nhs.items():
            nh.start_replica(ADDRS, False, RefKV, ref.Config(
                replica_id=rid, shard_id=1, election_rtt=20,
                heartbeat_rtt=2))
        res = _run_script(nhs, lambda nh: nh.get_noop_session(1))
        devices = {rid: nh.balance_shard_stats()[0]["device"]
                   for rid, nh in nhs.items()}
    finally:
        for nh in nhs.values():
            nh.close()
        mp.undo()
    return res, devices


# the port cluster's hosts: one engine a host, on meshes of 2 and 4 blocks
HOST_MESH = {1: 2, 2: 4, 3: 4}


def test_mesh_engine_cluster_matches_reference(tmp_path, reference_mesh_run):
    """A port cluster whose hosts step their replicas on
    ``torch_step_engine_factory(mesh=GroupsMesh(["cpu"] * D))``, D = 2 on
    one host and 4 on the others, with the parity self-check armed,
    applies SCRIPT as the reference's mesh-engine cluster does: the same
    commands in the same order and the same state machine contents on
    every replica.  A second, idle shard takes the other of each
    engine's first two striped rows (blocks 0 and 1: whichever shard
    steps first takes block 0); the balance plane reads each replica's
    block."""
    from dragonboat_tpu_torch.config import (
        EngineConfig,
        ExpertConfig,
        NodeHostConfig,
    )
    from dragonboat_tpu_torch.nodehost import NodeHost
    from dragonboat_tpu_torch.ops.engine import torch_step_engine_factory
    from dragonboat_tpu_torch.storage.logdb import in_mem_logdb_factory
    from dragonboat_tpu_torch.transport.inproc import reset_inproc_network
    from test_torch_engine import wait_for_leader

    want, want_dev = reference_mesh_run
    reset_inproc_network()
    nhs = {
        rid: NodeHost(NodeHostConfig(
            nodehost_dir=str(tmp_path / f"nh-{rid}"), rtt_millisecond=20,
            raft_address=ADDRS[rid],
            expert=ExpertConfig(
                engine=EngineConfig(exec_shards=1, apply_shards=2),
                logdb_factory=in_mem_logdb_factory,
                step_engine_factory=torch_step_engine_factory(
                    **GEOM, mesh=GroupsMesh(["cpu"] * HOST_MESH[rid]),
                    parity_every=4),
            ),
        ))
        for rid in ADDRS
    }
    try:
        for shard in (2, 1):
            for rid, nh in nhs.items():
                nh.start_replica(ADDRS, False, PortKV,
                                 shard_config(rid, shard_id=shard))
        got = _run_script(nhs, lambda nh: nh.get_noop_session(1))
        wait_for_leader(nhs, 2)
        devs = {rid: {b["shard_id"]: b["device"]
                      for b in nh.balance_shard_stats()}
                for rid, nh in nhs.items()}
        engines = {rid: nh.engine.step_engine for rid, nh in nhs.items()}
        coords = {rid: {s_: e.device_coordinate(s_) for s_ in (1, 2)}
                  for rid, e in engines.items()}
        chips = {rid: nh.device_chip_count() for rid, nh in nhs.items()}
        st = {rid: e.stats_snapshot() for rid, e in engines.items()}
    finally:
        for nh in nhs.values():
            nh.close()
    data = want[1][1]
    for rid in ADDRS:
        assert _squash(want[rid][0]) == SCRIPT, f"reference replica {rid}"
        assert _squash(got[rid][0]) == _squash(want[rid][0]), rid
        assert got[rid][1] == want[rid][1] == data, rid
    # a fresh engine's first row is block 0's (the reference's alone
    # shard), its next block 1's
    assert want_dev == {1: 0, 2: 0, 3: 0}, want_dev
    assert devs == coords, (devs, coords)
    assert all(sorted(c.values()) == [0, 1] for c in coords.values()), coords
    assert chips == HOST_MESH
    for rid, s_ in st.items():
        assert s_["divergence_halts"] == 0, s_
        assert s_["parity_failures"] == 0, s_
        assert s_["device_steps"] > 0, s_
        assert s_["parity_checked_launches"] == s_[
            "parity_step_attempts"] > 0, s_
        assert s_["parity_checked_row_moves"] == s_[
            "parity_row_attempts"] > 0, s_


def _colo_cluster(tmp_path, mesh, tag, parity_every=4):
    from dragonboat_tpu_torch.config import (
        EngineConfig,
        ExpertConfig,
        NodeHostConfig,
    )
    from dragonboat_tpu_torch.nodehost import NodeHost
    from dragonboat_tpu_torch.transport.inproc import reset_inproc_network

    reset_inproc_network()
    group = PC.ColocatedEngineGroup(capacity=16, P=P, W=W, M=8, E=E, O=O,
                                    budget=B, mesh=mesh,
                                    parity_every=parity_every)
    addrs = {r: f"colo-mesh-{tag}-{r}" for r in (1, 2, 3)}
    nhs = {
        rid: NodeHost(NodeHostConfig(
            nodehost_dir=str(tmp_path / f"nh-{tag}-{rid}"),
            rtt_millisecond=20, raft_address=addrs[rid],
            expert=ExpertConfig(
                engine=EngineConfig(exec_shards=1, apply_shards=2),
                step_engine_factory=group.factory,
            ),
        ))
        for rid in addrs
    }
    return group, nhs, addrs


def _start(nhs, addrs, shards):
    from test_torch_colocated import colo_shard_config

    for shard in shards:
        for rid, nh in nhs.items():
            nh.start_replica(addrs, False, PortKV,
                             colo_shard_config(rid, shard_id=shard))


def _propose_all(nhs, shards, n, tag):
    from test_torch_engine import propose_r, set_cmd, wait_for_leader

    want = {}
    for s_ in shards:
        lid = wait_for_leader(nhs, s_)
        nh = nhs[lid]
        for i in range(n):
            cmd = set_cmd(f"{tag}{s_}-{i}", f"v{i}".encode())
            propose_r(nh, nh.get_noop_session(s_), cmd)
            want.setdefault(s_, []).append(cmd)
    return want


def _applied_everywhere(nhs, want, deadline=20.0):
    from test_torch_engine import read_r

    for s_, cmds in want.items():
        for rid, nh in nhs.items():
            end = time.time() + deadline
            while True:
                got = _squash(read_r(nh, s_, "__applied__"))
                if len(got) >= len(cmds) or time.time() > end:
                    break
                time.sleep(0.05)
            assert got == cmds, (s_, rid)


def test_colocated_mesh_lane_slices(tmp_path):
    """The port of ``test_updatelanes.py::test_sharded_mesh_lane_slices``
    at D = 2: live traffic with the parity self-check armed, the update
    lanes' per-device slices tile the block, and every resident row's
    lane column lives in the slice of the block its coordinate names and
    mirrors its scalar raft."""
    from dragonboat_tpu_torch.ops import hostplane as hp
    from dragonboat_tpu_torch.ops import placement
    from dragonboat_tpu_torch.ops.types import R_TERM

    n_dev, cap = 2, 16
    old_parity = hp.PARITY
    hp.PARITY = True
    hp.PARITY_FAILURES.clear()
    group, nhs, addrs = _colo_cluster(tmp_path, GroupsMesh(["cpu"] * n_dev),
                                      "slices")
    try:
        _start(nhs, addrs, (1,))
        want = _propose_all(nhs, (1,), 12, "m")
        _applied_everywhere(nhs, want)
        core = group.core
        assert core.stats["launches"] > 0
        assert hp.PARITY_FAILURES == [], hp.PARITY_FAILURES[:3]
        per = placement.rows_per_device(cap, n_dev)
        with core._lock:
            parts = [core._ulanes.device_slice(d, n_dev)
                     for d in range(n_dev)]
            assert np.array_equal(np.concatenate(parts, axis=1),
                                  core._ulanes.words)
            n_res = 0
            for (sid, rid), g in core._row_of.items():
                meta = core._meta.get(g)
                if meta is None:
                    continue
                n_res += 1
                d = placement.device_of_row(g, cap, n_dev)
                assert d == core.device_coordinate(sid, rid), (sid, rid)
                sl = core._ulanes.device_slice(d, n_dev)
                assert sl[R_TERM, g - d * per] == meta.node.peer.raft.term
            assert n_res > 0
    finally:
        hp.PARITY = old_parity
        for nh in nhs.values():
            nh.close()
    st = group.core.stats_snapshot()
    assert st["divergence_halts"] == 0 and st["parity_failures"] == 0, st


def test_colocated_mesh_straddling_shards_ride_the_lane(tmp_path,
                                                        monkeypatch):
    """Capacity 16 on 4 blocks of 4 rows, 5 shards x 3 replicas: a block
    holds at most one whole shard, so shards straddle blocks whatever
    the attach order.  Their traffic rides the lane (sent and delivered
    above 0, no lane drop), every replica applies the same commands, no
    parity check fails, and every route step of the run — replayed
    through the reference's ``_route_step`` on the same global rows,
    sharded over a 4-device jax mesh — gives the same merged state,
    regions, delivered bits and flag words, and route stats whose sums
    are the engine's ``routed_delivered`` / ``routed_dropped``."""
    D = 4
    jm = jax_mesh(D)
    ref_stats = np.zeros((6,), np.int64)
    bad = []
    orig = PC.ColocatedTorchEngine._route_blocks

    def replayed(self, old, new, out, combo, combo_all, parity):
        args = tuple(join(self, x) for x in (old, new, out))
        per = self._blocks.per
        dl, dd, rk = (self._blocks.numpy(t) for t in zip(*self._lane_tabs))
        dest = np.where(dd >= 0, dd * per + dl, -1).astype(np.int32)
        combo_np = combo_all[0].numpy().copy()
        res = orig(self, old, new, out, combo, combo_all, parity)
        try:
            want = JC._route_step(
                *on_jax_mesh(args, jm), jnp.asarray(dest), jnp.asarray(rk),
                jnp.asarray(combo_np), PB=PB, E=E, budget=B)
            for name, w, g in zip(("merged", "regions", "packed", "flags"),
                                  (want[0], want[1], want[3], want[4]),
                                  (res[0], res[1], res[3], res[4])):
                assert_same(w, to_port(join(self, g)), name)
            ref_stats[:] += np.asarray(want[2])
        except AssertionError as exc:
            bad.append(str(exc))
        return res

    monkeypatch.setattr(PC.ColocatedTorchEngine, "_route_blocks", replayed)
    shards = (1, 2, 3, 4, 5)
    group, nhs, addrs = _colo_cluster(tmp_path, GroupsMesh(["cpu"] * D),
                                      "straddle")
    try:
        _start(nhs, addrs, shards)
        want = _propose_all(nhs, shards, 2, "s")
        _applied_everywhere(nhs, want)
        core = group.core
        blocks = {s_: {core.device_coordinate(s_, r) for r in (1, 2, 3)}
                  for s_ in shards}
    finally:
        for nh in nhs.values():
            nh.close()
    st = group.core.stats_snapshot()
    assert any(len(b) > 1 for b in blocks.values()), blocks
    assert bad == [], bad[:3]
    assert st["lane_sent"] > 0 and st["lane_delivered"] > 0, st
    assert st["lane_dropped_xlane"] == 0, st
    assert st["divergence_halts"] == 0 and st["parity_failures"] == 0, st
    for k in ("xlane_pack", "xlane_scatter", "route"):
        assert st[f"parity_checks_{k}"] == st[f"parity_attempts_{k}"] > 0
    assert st["routed_delivered"] == ref_stats[0] > 0, (st, ref_stats)
    assert st["routed_dropped"] == ref_stats[1:4].sum(), (st, ref_stats)
    assert st["routed_host_carried"] == ref_stats[5], (st, ref_stats)


# --------------------------------------------------------------------------
# errors
# --------------------------------------------------------------------------
def test_mesh_errors():
    with pytest.raises(ValueError, match="divide"):
        TorchStepEngine(None, capacity=16, mesh=GroupsMesh(["cpu"] * 3))
    with pytest.raises(ValueError, match="divide"):
        PC.ColocatedEngineGroup(
            capacity=16, mesh=GroupsMesh(["cpu"] * 3)).factory(None)
    # a CUDA device in a mesh without a card, alone or beside the CPU
    for devs in (["cuda:0"] * 2, ["cpu", "cuda:0"]):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is visible")
        with pytest.raises(RuntimeError, match="CUDA"):
            GroupsMesh(devs)
    # no device with the mesh: the mesh decides it (no card needed)
    group = PC.ColocatedEngineGroup(capacity=16, mesh=GroupsMesh(["cpu"]))
    assert group.factory(None).device_chip_count() == 1
    assert group.core._device is None


from test_torch_host_step import shim  # noqa: E402,F401 — the host C++ build
