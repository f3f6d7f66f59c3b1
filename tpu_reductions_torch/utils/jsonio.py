"""Atomic JSON artifact writes (the port's copy of
tpu_reductions/utils/jsonio.atomic_json_dump).

A race persists its artifact after every candidate; a process killed in
the middle of a write must leave the previous complete artifact or the new
one, never a truncation: temp file, fsync, then rename.
"""

from __future__ import annotations

import json
import os


def atomic_json_dump(path: str | os.PathLike, obj, *,
                     indent: int | None = 1) -> None:
    """Serialize `obj` to `path` via temp file + fsync + os.replace."""
    path = os.fspath(path)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=indent)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
