"""The controls and the planted faults that ``correct`` has to catch.

Each is a stand-in for the program's fused wave, with the program's
signature, put in its place for a run's timed window (``control.py`` on
the card at the cells' own sizes, ``tests/`` on the CPU at a small one):

* ``control_commit`` and ``control_lease``: the reference in the
  program's place, with one guarantee of the configuration broken.  The
  configuration states no precision (every word is int32), so a control
  breaks a guarantee instead of computing in a lower one.
  ``control_commit``: a leader commits every entry it holds as soon as
  it has appended it, without waiting for a quorum of voters (the write
  path).  ``control_lease``: a follower's election timer keeps running
  through its leader's heartbeats, so a follower of a live leader
  campaigns (the idle path: ticks and heartbeats only).
* ``state_unchanged``: the program runs, and the launch returns the state
  it was given.
* ``half_batch``: the program steps only the first half of the rows (by
  whole groups); the other half keep their state and get an empty inbox.
* ``answer_altered``: the program runs, and one word of the next inbox
  (a commit index carried by a message) is altered where it is produced.
* ``route_dropped``: the program runs, and the next inbox carries only
  the injected tick and proposal slots: the exchange between replicas is
  left out.
"""
from __future__ import annotations

import torch

from .harness.loop import program_rounds
from .reference import layout as RL
from .reference import route as RR
from .reference import step as RS


def _commit_without_quorum(old, inbox, new):
    lead = new.role == RL.ROLE_LEADER
    return new._replace(committed=torch.where(
        lead, torch.maximum(new.committed, new.last_index), new.committed))


def _timer_through_heartbeats(old, inbox, new):
    heard = ((inbox.mtype == RL.MT_HEARTBEAT).any(dim=1)
             & (new.role == RL.ROLE_FOLLOWER))
    return new._replace(election_tick=torch.where(
        heard, old.election_tick + 1, new.election_tick))


def _broken_reference(broken):
    """The reference's fused wave with ``broken(old, inbox, new)``
    rewriting each round's stepped state; on the program's operands,
    returning the program's tree types."""

    def rounds_fn(state, inbox, dest, rank, *, rounds, out_capacity, budget,
                  base, propose_leaders, propose_n, **_):
        ptypes = (type(state), type(inbox))
        st = RL.DeviceState(*[t.clone() for t in state])
        ib = RL.Inbox(*[t.clone() for t in inbox])
        M, E = ib.mtype.shape[1], ib.ent_term.shape[2]
        stats, escs = [], []
        for _ in range(rounds):
            new, out = RS.step(st, ib, out_capacity)
            new = broken(st, ib, new)
            st, ib, s, e = RR.merge_and_route(
                st, new, out, dest, rank, M=M, E=E, budget=budget, base=base,
                propose_leaders=propose_leaders, propose_n=propose_n)
            stats.append(s)
            escs.append(e)
        return (ptypes[0](*st), ptypes[1](*ib), torch.stack(stats),
                torch.stack(escs))

    return rounds_fn


control_commit = _broken_reference(_commit_without_quorum)
control_lease = _broken_reference(_timer_through_heartbeats)


def state_unchanged(state, inbox, dest, rank, **kw):
    _st, ib, stats, n_esc = program_rounds(state, inbox, dest, rank, **kw)
    return state, ib, stats, n_esc


def _half_rows(dest) -> int:
    """The first row of the group that holds row G // 2 (rows of a group
    route to each other, so its lowest destination is its first row)."""
    G = dest.shape[0]
    d = dest[G // 2]
    return int(d[d >= 0].min())


def half_batch(state, inbox, dest, rank, **kw):
    h = _half_rows(dest)
    st, ib, stats, n_esc = program_rounds(state, inbox, dest, rank, **kw)
    st = type(st)(*[torch.cat([a[:h], b[h:]]) for a, b in zip(st, state)])
    ib = type(ib)(*[torch.cat([a[:h], torch.zeros_like(a[h:])]) for a in ib])
    return st, ib, stats, n_esc


def answer_altered(state, inbox, dest, rank, **kw):
    st, ib, stats, n_esc = program_rounds(state, inbox, dest, rank, **kw)
    commit = ib.commit.clone()
    # the first routed message of the inbox gets a commit one higher
    occupied = (ib.mtype[:, kw["base"]:] != 0).reshape(-1).nonzero()
    if occupied.numel():
        M = ib.mtype.shape[1] - kw["base"]
        i = int(occupied[0])
        commit[i // M, kw["base"] + i % M] += 1
    return st, ib._replace(commit=commit), stats, n_esc


def route_dropped(state, inbox, dest, rank, **kw):
    st, ib, stats, n_esc = program_rounds(state, inbox, dest, rank, **kw)
    b = kw["base"]
    ib = type(ib)(*[torch.cat([a[:, :b], torch.zeros_like(a[:, b:])], dim=1)
                    for a in ib])
    return st, ib, stats, n_esc


VARIANTS = {
    "control_commit": control_commit,
    "control_lease": control_lease,
    "state_unchanged": state_unchanged,
    "half_batch": half_batch,
    "answer_altered": answer_altered,
    "route_dropped": route_dropped,
}
