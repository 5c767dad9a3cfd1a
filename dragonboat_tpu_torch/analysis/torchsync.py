"""torchsync: the torch syncs raftlint's rules cannot see.

raftlint (carried from the reference) knows the JAX spellings of a
device->host sync: ``.item()``, ``int(...)``, ``np.asarray(...)`` and
``jax.device_get(...)``.  The port's device values are torch tensors, and
torch syncs under other names.  This is a second pass over the SAME
scopes, read from raftlint's own tables, under the SAME rule ids, so the
existing ``# raftlint: ignore[...]`` comments (point and def-line,
``_func_exempt``) apply unchanged:

``host-sync``
    In the pure-device modules (``HOST_SYNC_MODULES``: ``ops/kernel.py``,
    ``ops/route.py``): a bare ``.cpu()``, ``.numpy()``, ``.tolist()`` or
    ``.to("cpu")`` of a tensor, ``torch.cuda.synchronize()`` or ``<event
    or stream>.synchronize()``.  The launch path calls the first four on
    host numpy arrays far more often than on tensors, so a receiver
    counts only where the function shows it is a tensor: a parameter
    annotated ``Tensor``, ``DeviceState``, ``DeviceOut``, ``Inbox`` or
    ``Sharded`` (or an attribute of one), such a container built, the
    result of a ``torch.*`` call or of a function of the module whose
    return annotation names one of those types, or a name, index,
    arithmetic or tensor method result built from those.  A readback of a value this cannot see is the card's to
    catch: ``chip_smoke.py`` runs every all-device entry under
    ``torch.cuda.set_sync_debug_mode("error")``.

``sync-budget``
    The same calls inside a ``# sync-hot`` function of the launch
    pipeline (``SYNC_BUDGET_MODULES``): the budget is one commit-proving
    readback a generation, and each sanctioned one carries its point
    ignore.

``mesh-loop``
    Inside a ``# mesh-hot`` function (``MESH_MODULES``): a device
    ``.to(...)`` (anything but a dtype cast) or a ``copy_``, each a
    host-driven cross-device move, and a Python loop or comprehension
    over the device blocks (``.parts``, ``.devices``, ``range(D)``,
    ``mesh.size``) — the reference dispatches ONE program for every
    chip, the port one launch a block (loops over ``jax``-style
    ``devices`` that raftlint already reports are not reported twice).

``lint_source`` / ``lint_paths`` return raftlint's findings plus this
pass's, so one gate (``raftlint.gate``) covers both.
"""
from __future__ import annotations

import ast
import os
from typing import List

from . import raftlint
from .raftlint import Finding, _Linter

# calls that wait for the device and bring its data to the host
_SYNC_METHODS = {"cpu", "numpy", "tolist"}
# the names a `.to(x)` dtype cast spells (anything else moves devices)
_DTYPE_NAMES = {
    "I32", "U32", "I64", "BOOL", "bool", "int", "long", "float",
    "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
    "uint64", "float16", "float32", "float64", "bfloat16",
}
# what a per-block iteration mentions (the mesh's blocks and devices)
_BLOCK_ATTRS = {"parts", "devices", "D"}
_BLOCK_NAMES = {"D", "n_dev", "n_devices", "devices"}


# annotations that declare a device value (a tensor or a tuple of them)
_DEVICE_TYPES = {"Tensor", "DeviceState", "DeviceOut", "Inbox", "Sharded"}
# torch namespaces whose calls return no tensor
_TORCH_NON_TENSOR = {"cuda", "device", "dtype", "Size", "backends",
                     "distributed", "profiler", "is_tensor", "numel"}
# tensor attributes and methods whose value lives on the host
_HOST_VALUES = {"tolist", "item", "numpy", "size", "dim", "numel",
                "data_ptr", "stride", "element_size", "untyped_storage",
                "is_contiguous", "shape", "dtype", "device", "ndim",
                "is_cuda", "synchronize"}


def _torch_root(expr: ast.AST):
    """The first attribute of a ``torch.a.b...`` chain, or None."""
    first = None
    while isinstance(expr, ast.Attribute):
        first = expr.attr
        expr = expr.value
    return first if isinstance(expr, ast.Name) and expr.id == "torch" \
        else None


def _declares_device(annotation: ast.AST) -> bool:
    return any(isinstance(n, ast.Name) and n.id in _DEVICE_TYPES
               or isinstance(n, ast.Attribute) and n.attr in _DEVICE_TYPES
               or isinstance(n, ast.Constant) and isinstance(n.value, str)
               and any(t in n.value for t in _DEVICE_TYPES)
               for n in ast.walk(annotation))


def _is_tensor(expr: ast.AST, names, makers=frozenset()) -> bool:
    """Whether ``expr`` is shown to be a tensor, given the ``names``
    bound to device values and the ``makers``, functions of the module
    whose return annotation declares one."""
    def rec(e):
        return _is_tensor(e, names, makers)

    if isinstance(expr, ast.Name):
        return expr.id in names
    if isinstance(expr, ast.Attribute):
        return expr.attr not in _HOST_VALUES and rec(expr.value)
    if isinstance(expr, ast.Subscript):
        return rec(expr.value)
    if isinstance(expr, ast.BinOp):
        return rec(expr.left) or rec(expr.right)
    if isinstance(expr, ast.UnaryOp):
        return rec(expr.operand)
    if isinstance(expr, ast.Compare):
        return any(rec(e) for e in [expr.left, *expr.comparators])
    if isinstance(expr, ast.IfExp):
        return rec(expr.body) or rec(expr.orelse)
    if isinstance(expr, ast.Call):
        f = expr.func
        name = f.id if isinstance(f, ast.Name) else (
            f.attr if isinstance(f, ast.Attribute) else None)
        if name in _DEVICE_TYPES or name in makers:
            return True  # a device container built, or a maker's result
        if isinstance(f, ast.Attribute):
            root = _torch_root(f)
            if root is not None:
                return root not in _TORCH_NON_TENSOR
            return f.attr not in _HOST_VALUES and rec(f.value)
    return False


def _bound_names(target: ast.AST):
    if isinstance(target, ast.Name):
        yield target.id
    elif isinstance(target, (ast.Tuple, ast.List)):
        for t in target.elts:
            yield from _bound_names(t)
    elif isinstance(target, ast.Starred):
        yield from _bound_names(target.value)


def _device_names(fn, makers=frozenset()) -> frozenset:
    """The names ``fn`` binds to device values: parameters and
    annotated names declared so, and names assigned from an expression
    ``_is_tensor`` shows is one (to a fixed point, whatever the order of
    the assignments)."""
    a = fn.args
    names = {p.arg for p in [*a.posonlyargs, *a.args, *a.kwonlyargs,
                             a.vararg, a.kwarg]
             if p is not None and p.annotation is not None
             and _declares_device(p.annotation)}
    binds = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            binds += [(t, node.value) for t in node.targets]
        elif isinstance(node, ast.AnnAssign):
            if _declares_device(node.annotation):
                names.update(_bound_names(node.target))
            elif node.value is not None:
                binds.append((node.target, node.value))
        elif isinstance(node, ast.NamedExpr):
            binds.append((node.target, node.value))
    grew = True
    while grew:
        grew = False
        for target, value in binds:
            if _is_tensor(value, names, makers):
                new = set(_bound_names(target)) - names
                names |= new
                grew = grew or bool(new)
    return frozenset(names)


def _is_dtype(expr: ast.AST) -> bool:
    if isinstance(expr, ast.Name):
        return expr.id in _DTYPE_NAMES or expr.id.endswith("dtype")
    if isinstance(expr, ast.Attribute):
        return expr.attr in _DTYPE_NAMES or expr.attr.endswith("dtype")
    return False


def _mentions_blocks(expr: ast.AST) -> bool:
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Attribute):
            if sub.attr in _BLOCK_ATTRS:
                return True
            if (sub.attr == "size" and isinstance(sub.value, ast.Name)
                    and sub.value.id == "mesh"):
                return True
        if isinstance(sub, ast.Name) and sub.id in _BLOCK_NAMES:
            return True
    return False


class _TorchSync(_Linter):
    """raftlint's walker (scopes, hot-function depths, suppression) with
    only this pass's checks."""

    def __init__(self, relpath: str, source: str, tree: ast.Module):
        super().__init__(relpath, source, tree)
        # raftlint's own rules are raftlint's: keep only the scope flags
        # this pass reads (host-sync, sync-hot and mesh-hot depths)
        self.check_imports = self.check_determinism = False
        self.check_width = self.check_stream_read = False
        self.check_gateway = self.check_hostplane = False
        self.check_obs_bound = False
        self._names = {}
        self._makers = frozenset(
            n.name for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and n.returns is not None and _declares_device(n.returns))

    def collect(self) -> None:  # no guarded-by fields, no struct tables
        return

    def _device_values(self) -> frozenset:
        """The names bound to device values in the functions that enclose
        the node being visited."""
        names = frozenset()
        for fn in self._func_stack:
            if fn not in self._names:
                self._names[fn] = _device_names(fn, self._makers)
            names |= self._names[fn]
        return names

    # -- the calls ---------------------------------------------------------
    def _sync_call(self, node: ast.Call):
        """What a call syncs, or None."""
        f = node.func
        if not isinstance(f, ast.Attribute):
            return None
        if f.attr == "synchronize":
            return f"{ast.unparse(f)}() blocks the host on the device"
        if not _is_tensor(f.value, self._device_values(), self._makers):
            return None
        if f.attr in _SYNC_METHODS and not node.args:
            return f".{f.attr}() waits for the device and copies to the host"
        if f.attr == "to" and (
            any(isinstance(a, ast.Constant) and a.value == "cpu"
                for a in node.args)
            or any(k.arg == "device" and isinstance(k.value, ast.Constant)
                   and k.value.value == "cpu" for k in node.keywords)
        ):
            return '.to("cpu") waits for the device and copies to the host'
        return None

    @staticmethod
    def _device_move(node: ast.Call):
        f = node.func
        if not isinstance(f, ast.Attribute):
            return None
        if f.attr == "copy_":
            return ".copy_(...)"
        if f.attr != "to":
            return None
        if any(k.arg == "device" for k in node.keywords):
            return ".to(device=...)"
        if node.args and not _is_dtype(node.args[0]):
            return f".to({ast.unparse(node.args[0])})"
        return None

    def visit_Call(self, node: ast.Call) -> None:
        hit = self._sync_call(node)
        if hit and self.check_host_sync and not self._func_exempt("host-sync"):
            self._emit("host-sync", node.lineno,
                       hit + " (a host sync on the device plane)")
        if hit and self._sync_depth and not self._func_exempt("sync-budget"):
            self._emit("sync-budget", node.lineno,
                       hit + " in the launch pipeline, outside the one "
                       "commit-proving readback a generation")
        if self._mesh_depth and not self._func_exempt("mesh-loop"):
            move = self._device_move(node)
            if move:
                self._emit("mesh-loop", node.lineno,
                           f"{move} inside a # mesh-hot function — a "
                           "host-driven device move on the sharded launch "
                           "path")
        self.generic_visit(node)

    # -- per-block loops on the mesh path --------------------------------------
    def _block_loop(self, node, iters, what: str) -> None:
        if not self._mesh_depth or self._func_exempt("mesh-loop"):
            return
        if any(_mentions_blocks(it) for it in iters):
            self._emit("mesh-loop", node.lineno,
                       f"{what} over the device blocks inside a # mesh-hot "
                       "function — one launch a block from the host, where "
                       "the reference dispatches ONE program for every chip")

    def visit_For(self, node: ast.For) -> None:
        if not self._mentions_devices(node.iter):  # raftlint reports those
            self._block_loop(node, [node.iter], "`for` loop")
        self.generic_visit(node)

    def _visit_comp(self, node) -> None:
        self._block_loop(node, [g.iter for g in node.generators],
                         "comprehension")
        self.generic_visit(node)

    visit_ListComp = visit_SetComp = visit_DictComp = _visit_comp
    visit_GeneratorExp = _visit_comp

    def visit_AsyncFor(self, node) -> None:
        self.generic_visit(node)

    def visit_ExceptHandler(self, node) -> None:
        self.generic_visit(node)

    def _check_import(self, node) -> None:
        return


def torch_findings(source: str, relpath: str) -> List[Finding]:
    """This pass alone over one source blob (as if at ``relpath``)."""
    tree = ast.parse(source, filename=relpath)
    return _TorchSync(relpath, source, tree).run()


def lint_source(source: str, relpath: str) -> List[Finding]:
    """raftlint's findings plus this pass's, for one source blob."""
    return raftlint.lint_source(source, relpath) + torch_findings(
        source, relpath)


def lint_paths(paths) -> List[Finding]:
    """raftlint's ``lint_paths`` plus this pass over the same files."""
    findings = raftlint.lint_paths(paths)
    for path in raftlint._iter_py_files(paths):
        rel = os.path.relpath(path).replace(os.sep, "/")
        with open(path, "r", encoding="utf-8") as f:
            src = f.read()
        try:
            findings.extend(torch_findings(src, rel))
        except SyntaxError:
            pass  # raftlint reported it as parse-error
    return findings
