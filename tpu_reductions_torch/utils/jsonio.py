"""Atomic artifact writes (the port's copy of
tpu_reductions/utils/jsonio.atomic_json_dump and atomic_text_dump).

A race persists its artifact after every candidate; a process killed in
the middle of a write must leave the previous complete artifact or the new
one, never a truncation: temp file, fsync, then rename.
"""

from __future__ import annotations

import json
import os


def _write_atomic(path: str | os.PathLike, write) -> None:
    """`write(f)` into a temp file beside `path`, fsync, os.replace."""
    path = os.fspath(path)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def atomic_json_dump(path: str | os.PathLike, obj, *,
                     indent: int | None = 1) -> None:
    """Serialize `obj` to `path` via temp file + fsync + os.replace.
    `indent=None` writes the compact one-line form and a newline, the
    form of the sweep's per-cell cache files."""
    def write(f):
        json.dump(obj, f, indent=indent)
        if indent is None:
            f.write("\n")
    _write_atomic(path, write)


def atomic_text_dump(path: str | os.PathLike, text: str) -> None:
    """The same durability for a text artifact (report.md, report.tex)."""
    _write_atomic(path, lambda f: f.write(text))
