"""Checkpoint manager (pkg/kubelet/checkpointmanager/checkpoint_manager.go:36,56); an own copy of
``kubernetes_tpu/kubelet/checkpoint.py``.

The one reference component with durable local state: checksummed files so
device-manager allocations survive kubelet restarts. Same contract here:
JSON payload + CRC; a corrupt or tampered file fails verification on read.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Optional


class CorruptCheckpointError(Exception):
    """Checksum mismatch (errors.ErrCorruptCheckpoint)."""


class CheckpointManager:
    def __init__(self, checkpoint_dir: str):
        self.dir = checkpoint_dir
        os.makedirs(checkpoint_dir, exist_ok=True)

    def _path(self, name: str) -> str:
        if "/" in name or name.startswith("."):
            raise ValueError(f"invalid checkpoint name {name!r}")
        return os.path.join(self.dir, name)

    def create_checkpoint(self, name: str, data: dict) -> None:
        """Atomic write: payload + crc32, tmp-then-rename
        (checkpoint_manager.go CreateCheckpoint)."""
        payload = json.dumps(data, sort_keys=True)
        doc = {"data": payload, "checksum": zlib.crc32(payload.encode())}
        tmp = self._path(name) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, self._path(name))

    def get_checkpoint(self, name: str) -> Optional[dict]:
        """Read + verify; None when absent, CorruptCheckpointError on
        checksum mismatch (GetCheckpoint + VerifyChecksum)."""
        try:
            with open(self._path(name)) as f:
                doc = json.load(f)
        except FileNotFoundError:
            return None
        except (json.JSONDecodeError, OSError) as e:
            raise CorruptCheckpointError(str(e)) from e
        payload = doc.get("data", "")
        if zlib.crc32(payload.encode()) != doc.get("checksum"):
            raise CorruptCheckpointError(name)
        return json.loads(payload)

    def remove_checkpoint(self, name: str) -> None:
        try:
            os.remove(self._path(name))
        except FileNotFoundError:
            pass

    def list_checkpoints(self) -> list:
        return sorted(
            n for n in os.listdir(self.dir) if not n.endswith(".tmp")
        )
