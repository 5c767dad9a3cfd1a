"""Correctness tooling of the port, over the port's own tree.

* :mod:`.raftlint` — the project's AST linter, carried from the
  reference with its rule scopes pointed at ``dragonboat_tpu_torch/``;
  :mod:`.torchsync` is its second pass over the same scopes, for the
  torch syncs the first pass cannot see (``.cpu()``, ``.numpy()``,
  ``.tolist()``, ``torch.cuda.synchronize()``, device ``.to(...)`` and
  ``copy_`` on the mesh path, per-block loops in ``# mesh-hot``
  functions).  Gate: zero findings beyond ``analysis/baseline.txt``.
* :mod:`.lockcheck` — the lock-order witness, carried byte for byte; its
  root is this package's parent, so it tracks locks created under
  ``dragonboat_tpu_torch/``.  Never install it in a process where the
  reference's witness is installed.
* :mod:`.wire_registry` / :mod:`.wirecheck` — the wire-compat auditor
  over the port's codecs, held to the reference's goldens in
  ``tests/wire_goldens/`` (the port never rewrites them).
* :mod:`.devicecheck` — the device-plane policies of the reference's
  program auditor, for the port's registry and its CUDA kernels
  (dtype, transfer, donation, G-last, unregistered kernels, spills).

CLI: ``python -m dragonboat_tpu_torch.analysis --help``.
"""
from .raftlint import Finding, lint_paths, lint_source, load_baseline  # noqa: F401
from . import lockcheck  # noqa: F401
