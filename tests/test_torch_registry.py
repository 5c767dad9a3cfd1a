"""The port's program registry against the reference's, on the CPU.

``dragonboat_tpu_torch/ops/registry.py`` lists the port's 21 device
programs under the reference's names (``ENTRY_POINTS`` and
``mesh_entry_points`` of ``dragonboat_tpu/ops/registry.py``), each with
its callable, its plain version and a numpy builder of the canonical
inputs.  Here:

* the names, their order and ``CANON`` equal the reference's;
* each of the 19 single-device entries gets the reference builder's
  inputs from its own builder (the one place the two signatures differ,
  the alive mask, is converted) and returns, on CPU tensors, bit for
  bit what the reference's jitted program returns;
* the same on seeded live inputs (``registry.live_world``: groups with
  leaders, logs past the ring window, inboxes over every hot message
  type, live route tables, dead rows), the port's inputs handed to the
  reference program leaf by leaf;
* each entry's callable equals its plain version (on the CPU the
  callable runs the plain version; the chip smoke's ``registry`` phase
  holds the CUDA kernels against the same plain versions, on canonical
  and on live inputs);
* the two mesh entries on ``GroupsMesh(["cpu"] * D)`` equal the
  single-device programs on the same global rows, canonical and live
  (the reference's own sharded programs pass ``check_rep``, which this
  jax refuses);
* the unregistered-kernel scan is clean on ``csrc/`` and names a
  planted ``m.def`` or ``__global__`` in a copy of the sources.
"""
from __future__ import annotations

import re
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonboat_tpu.ops import registry as ref_registry
from dragonboat_tpu_torch.ops import registry
from dragonboat_tpu_torch.ops.placement import GroupsMesh

ROOT = Path(__file__).resolve().parent.parent
REF_NAMES = re.findall(
    r'EntryPoint\(\s*"([\w.]+)"',
    (ROOT / "dragonboat_tpu/ops/registry.py").read_text())

PORT = {ep.name: ep for ep in registry.ENTRY_POINTS}
REF = {ep.name: ep for ep in ref_registry.ENTRY_POINTS}


def test_names_and_geometry_equal_the_reference():
    assert len(REF_NAMES) == 21
    names = [ep.name for ep in registry.all_entry_points(
        GroupsMesh(["cpu"] * 2))]
    assert names == REF_NAMES
    assert list(PORT) == list(REF) == REF_NAMES[:19]
    assert registry.CANON == ref_registry.CANON


def _norm(x) -> np.ndarray:
    a = np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)
    if a.dtype == np.bool_:
        return a.astype(np.int32)
    if a.dtype == np.uint32:
        return a.view(np.int32)
    return a


def _leaves_np(tree):
    if isinstance(tree, registry.Host):
        return [_norm(tree.value)]
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return [_norm(tree)]
    return [a for t in tree for a in _leaves_np(t)]


def _port_inputs_as_reference(name, args):
    """The port builder's operands as the reference program takes them:
    the assemble's [G, 4] combo carries the reference's [G] alive mask
    in its lane 0."""
    leaves = _leaves_np(args)
    if name == "colocated._assemble_inbox":
        leaves[-1] = (leaves[-1][:, 0] != 0).astype(np.int32)
    return leaves


def _same(got, want, what):
    assert len(got) == len(want), (what, len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = _norm(g), _norm(w)
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        assert np.array_equal(g, w), (what, i)


@pytest.mark.parametrize("name", list(REF))
def test_entry_matches_reference_program(name):
    ep, ref = PORT[name], REF[name]
    args, kw = ep.build()
    ref_args, ref_kw = ref.build()
    assert kw == ref_kw, name
    _same(_port_inputs_as_reference(name, args),
          jax.tree_util.tree_leaves(ref_args), f"{name} inputs")
    want = jax.tree_util.tree_leaves(ref.fn(*ref_args, **ref_kw))
    got = registry.leaves(ep.fn(*registry.materialize(args, "cpu"), **kw))
    _same(got, want, name)
    # the plain version, called directly, gives the same result
    _same(registry.run(ep, "cpu", plain=True), want, f"{name} plain")


LIVE_SEEDS = [1, 2]


def _reference_args(name, args, ref_args):
    """The port builder's operands as the reference program's operand
    tree (each leaf in the dtype and kind of the reference's canonical
    leaf)."""
    ref_leaves, tdef = jax.tree_util.tree_flatten(ref_args)
    leaves = _port_inputs_as_reference(name, args)
    assert len(leaves) == len(ref_leaves), name
    conv = []
    for a, r in zip(leaves, ref_leaves):
        a = np.asarray(a).astype(np.asarray(r).dtype)
        conv.append(jnp.asarray(a) if isinstance(r, jax.Array) else a)
    return jax.tree_util.tree_unflatten(tdef, conv)


@pytest.mark.parametrize("seed", LIVE_SEEDS)
@pytest.mark.parametrize("name", list(REF))
def test_entry_matches_reference_program_on_live_inputs(name, seed):
    ep, ref = PORT[name], REF[name]
    args, kw = ep.live(seed)
    ref_args, ref_kw = ref.build()
    assert kw == ref_kw, name
    ref_live = _reference_args(name, args, ref_args)
    want = jax.tree_util.tree_leaves(ref.fn(*ref_live, **ref_kw))
    got = registry.leaves(ep.fn(*registry.materialize(args, "cpu"), **kw))
    _same(got, want, name)
    _same(registry.run(ep, "cpu", plain=True, seed=seed), want,
          f"{name} plain")
    # the live inputs make the program work: its result is not the
    # canonical one
    canon = registry.run(ep, "cpu")
    assert any(g.shape != c.shape or not np.array_equal(_norm(g), _norm(c))
               for g, c in zip(got, canon)), name


def test_live_world_is_live():
    w = registry.live_world(LIVE_SEEDS[0])
    st, G = w["state"], registry.CANON["G"]
    from dragonboat_tpu_torch.ops import types as T

    assert (st.role == T.ROLE_LEADER).sum() == G // 3  # every group led
    assert st.last_index.max() > registry.CANON["W"]  # past the ring
    assert (w["fuzz_M"].mtype != 0).mean() > 0.4
    assert w["out_M"].escalate.any() and w["out_A"].count.sum() > 0
    assert 0 < w["combo"][:, 0].mean() < 1
    assert (registry.live_tables()[0] >= 0).sum() == 3 * (G - G % 3)


@pytest.mark.parametrize("seed", [None] + LIVE_SEEDS)
@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("name", ["kernel.step_sharded",
                                  "route.sharded_round"])
def test_mesh_entry_matches_single_device_program(name, D, seed):
    ep = registry.entry(name, GroupsMesh(["cpu"] * D))
    got = registry.run(ep, "cpu", seed=seed)
    _same(got, registry.run(ep, "cpu", plain=True, seed=seed), name)
    if name == "kernel.step_sharded":
        # the single-device program is the registered kernel.step
        _same(got, registry.run(PORT["kernel.step"], "cpu", seed=seed),
              name)


def test_mesh_round_tables_cross_blocks():
    """The round's canonical tables send every row's traffic to the
    block ``g % D``: at D > 1 most edges leave their block."""
    ep = registry.entry("route.sharded_round", GroupsMesh(["cpu"] * 4))
    (_st, _ib, dl, dd, _rk), _ = ep.build()
    per = registry.CANON["G"] // 4
    home = np.arange(registry.CANON["G"]) // per
    assert (dd != home[:, None]).mean() > 0.5 and (dl == 0).all()


def test_entries_cover_every_kernel():
    from dragonboat_tpu_torch.ops import _native

    assert set(registry.kernels()) == set(_native.KERNELS)
    assert set(registry.GLOBALS) == set(_native.ENTRIES) == {
        b for ep in registry.ENTRY_POINTS for b in ep.bindings} | set(
        b for v in registry.MESH_BINDINGS.values() for b in v)
    # the colocated product path's programs reach rows 1, 4-7, 9-11
    assert set(registry.kernels_of([
        "colocated._assemble_and_step", "colocated._route_step",
        "colocated._select_and_blob", "colocated._host_inbox_from_ticks",
        "colocated._scatter_inbox_rows"])) == {
        "inbox", "raft_step", "merge_escalated", "route",
        "summarize_flags", "select_and_blob", "gather_pack", "place_rows"}


def test_unregistered_kernel_scan_is_clean():
    defs, globs = registry.scan_sources()
    assert len(defs) == 14 and len(set(defs)) == 14
    assert len(globs) >= 18
    assert registry.unregistered_kernels() == []


@pytest.fixture
def csrc_copy(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(registry.CSRC, dst)
    return dst


def test_scan_names_a_planted_binding(csrc_copy):
    b = csrc_copy / "bindings.cpp"
    src = b.read_text()
    anchor = '  m.def("xlane_scatter"'
    assert src.count(anchor) == 1
    b.write_text(src.replace(
        anchor, '  m.def("widget_pack", &widget_pack, "csrc/widget.cu");\n'
        + anchor))
    found = registry.unregistered_kernels(csrc_copy)
    assert found == ["unregistered-binding: m.def 'widget_pack' is not in "
                     "GLOBALS and _native.ENTRIES"], found


def test_scan_names_a_planted_global_and_a_lost_binding(csrc_copy):
    (csrc_copy / "widget.cu").write_text(
        "__global__ void __launch_bounds__(256)\n"
        "    widget_kernel(const int* a) {}\n")
    b = csrc_copy / "bindings.cpp"
    src = b.read_text()
    line = re.search(r'^\s*m\.def\("zero_inbox_rows".*\n.*\n', src, re.M)
    b.write_text(src.replace(line.group(0), ""))
    found = registry.unregistered_kernels(csrc_copy)
    assert "unregistered-kernel: __global__ 'widget_kernel' is launched " \
        "by no binding in GLOBALS" in found, found
    assert "stale-binding: 'zero_inbox_rows' has no m.def" in found, found
    assert len(found) == 2, found


def test_entries_build_nothing_on_the_cpu(monkeypatch):
    """On CPU tensors no entry touches the kernels' build."""
    from dragonboat_tpu_torch.ops import _native

    def refuse():
        raise AssertionError("a CPU run reached the kernel build")

    monkeypatch.setattr(_native, "module", refuse)
    for ep in registry.all_entry_points(GroupsMesh(["cpu"] * 2)):
        registry.run(ep, "cpu")
