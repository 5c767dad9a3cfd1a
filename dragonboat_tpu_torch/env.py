"""NodeHost directory environment: exclusive lock + deployment id.

reference: internal/server/environment.go [U] — flock-based dir locking
(two NodeHost processes must never share a data dir) and deployment-ID
persistence (a nodehost dir created under one deployment must refuse to
open under another; the transport also stamps/validates the id on every
batch).
"""
from __future__ import annotations

import fcntl
import os
from typing import Optional

LOCK_FILENAME = "LOCK"
DEPLOYMENT_FILENAME = "DEPLOYMENT.ID"


class DirLockedError(Exception):
    """Another NodeHost holds this nodehost dir."""


class DeploymentIDMismatch(Exception):
    """The dir was created under a different deployment id."""


class Env:
    def __init__(self, nodehost_dir: str, deployment_id: int = 0):
        self.dir = nodehost_dir
        os.makedirs(nodehost_dir, exist_ok=True)
        self._lock_f = open(os.path.join(nodehost_dir, LOCK_FILENAME), "a+")
        try:
            fcntl.flock(self._lock_f, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            self._lock_f.close()
            raise DirLockedError(
                f"nodehost dir already locked: {nodehost_dir}"
            )
        self._check_deployment_id(deployment_id)

    def _check_deployment_id(self, deployment_id: int) -> None:
        path = os.path.join(self.dir, DEPLOYMENT_FILENAME)
        try:
            with open(path, "r", encoding="utf-8") as f:
                stored = int(f.read().strip() or "0")
        except ValueError:
            self.close()
            raise DeploymentIDMismatch(
                f"corrupt deployment-id file in {self.dir}"
            )
        except FileNotFoundError:
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(str(deployment_id))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            return
        if stored != deployment_id:
            self.close()
            raise DeploymentIDMismatch(
                f"dir {self.dir} belongs to deployment {stored}, "
                f"not {deployment_id}"
            )

    def close(self) -> None:
        if self._lock_f is not None:
            try:
                fcntl.flock(self._lock_f, fcntl.LOCK_UN)
            except OSError:
                pass
            self._lock_f.close()
            self._lock_f = None
