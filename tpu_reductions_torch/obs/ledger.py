"""Crash-safe append-only JSONL event ledger: the flight recorder.

The counterpart of tpu_reductions/obs/ledger.py, with the same contract:

  1. No torn lines. Every event is one `os.write` of one complete line to
     an O_APPEND fd, fsync'd, so concurrent writers interleave at line
     granularity and a kill loses at most the line in flight.
  2. Never the failure. `emit` never raises; an internal error disarms
     the ledger after one warning on stderr.
  3. Free when off. Unarmed (TPU_REDUCTIONS_LEDGER unset) or disabled
     (TPU_REDUCTIONS_OBS_DISABLE=1), `emit` is one attribute test.
  4. Host-side only: no device call, no sync; callers emit outside timed
     regions.

Row grammar: `{"t": <epoch>, "ev": "<type>", "pid": <pid>, ...}`, then the
heartbeat phase when a guard is open (utils/heartbeat.py), then the trace
fields `trace`/`span`/`parent` when a context is active (obs/trace.py),
then the caller's fields: a line's keys and their order are the JAX
ledger's for the same `emit`. TPU_REDUCTIONS_LEDGER_MAX_BYTES caps the
file: when the next line would pass it, the file is renamed whole to
`<path>.1` and a fresh one opened.

    python -m tpu_reductions_torch.obs.ledger <event> [key=value ...] \
        [--ledger PATH] [--platform=cpu]

Like every entry point of the port, the CLI resolves the card first and
raises without one unless --platform=cpu is given, though appending a
line touches no device.
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import threading
import time
from typing import Optional

from tpu_reductions_torch.lint.grammar import EVENT_NAME_RE

ENV_PATH = "TPU_REDUCTIONS_LEDGER"
ENV_DISABLE = "TPU_REDUCTIONS_OBS_DISABLE"
ENV_MAX_BYTES = "TPU_REDUCTIONS_LEDGER_MAX_BYTES"

_fd: Optional[int] = None
_path: Optional[str] = None
_max_bytes: Optional[int] = None
_session_open = False
# serializes arm/disarm/rotation/session state; the emit path reads _fd
# once and issues one line-atomic write without it
_state_lock = threading.Lock()


def disabled() -> bool:
    """TPU_REDUCTIONS_OBS_DISABLE=1: off, even when armed."""
    return os.environ.get(ENV_DISABLE) == "1"


def resolved_path(path: Optional[str | os.PathLike] = None
                  ) -> Optional[str]:
    """The ledger file: the argument, else TPU_REDUCTIONS_LEDGER, else
    None (recorder off)."""
    if path is not None:
        return os.fspath(path)
    return os.environ.get(ENV_PATH) or None


def armed() -> bool:
    """Whether emits reach a ledger file."""
    return _fd is not None and not disabled()


def _warn(msg: str) -> None:
    print(f"obs.ledger: {msg} (recorder disarmed; the run continues "
          "unobserved)", file=sys.stderr, flush=True)


def arm(path: Optional[str | os.PathLike] = None) -> Optional[str]:
    """Open (create) the ledger for appending; the path, or None when the
    recorder stays off. Idempotent for one path; arming another closes
    the previous fd."""
    global _fd, _path, _max_bytes
    if disabled():
        return None
    path = resolved_path(path)
    if path is None:
        return None
    with _state_lock:
        if _fd is not None and _path == path:
            return path
        try:
            fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        except OSError as e:
            _warn(f"cannot open ledger {path!r}: {e}")
            return None
        if _fd is not None:
            try:
                os.close(_fd)
            except OSError:
                pass
        _fd, _path = fd, path
        try:
            _max_bytes = int(os.environ.get(ENV_MAX_BYTES, ""))
            if _max_bytes <= 0:
                _max_bytes = None
        except ValueError:
            _max_bytes = None
    return path


def disarm() -> None:
    """Close the ledger and drop the process trace root."""
    global _fd, _path, _session_open, _max_bytes
    with _state_lock:
        if _fd is not None:
            try:
                os.close(_fd)
            except OSError:
                pass
        _fd, _path, _session_open, _max_bytes = None, None, False, None
    # outside _state_lock: the two module locks never nest
    try:
        from tpu_reductions_torch.obs import trace
        trace.reset()
    except Exception:
        pass


def _current_trace():
    try:
        from tpu_reductions_torch.obs import trace
        return trace.active()
    except Exception:
        return None


def _current_phase() -> Optional[str]:
    """The heartbeat phase of an open guard (this module only reads the
    heartbeat; the heartbeat emits through it)."""
    try:
        from tpu_reductions_torch.utils import heartbeat
        snap = heartbeat.snapshot()
        return snap["phase"] if snap["in_flight"] else None
    except Exception:
        return None


def _clean(v):
    """A JSON-safe field: non-finite floats become null, unknown types
    their str."""
    if isinstance(v, float) and (v != v or v in (float("inf"),
                                                 float("-inf"))):
        return None
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_clean(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _clean(x) for k, x in v.items()}
    return str(v)


def emit(ev: str, **fields) -> bool:
    """Append one event; True iff a line landed. Never raises. The
    heartbeat phase is attached when the caller passes none, the trace
    fields when the caller passes no `trace`."""
    if _fd is None or disabled():
        return False
    try:
        if not EVENT_NAME_RE.match(ev):
            _warn_once_bad_name(ev)
            return False
        rec = {"t": round(time.time(), 6), "ev": ev, "pid": os.getpid()}
        if "phase" not in fields:
            phase = _current_phase()
            if phase is not None:
                rec["phase"] = phase
        if "trace" not in fields:
            tr = _current_trace()
            if tr is not None:
                rec["trace"] = tr.trace_id
                rec["span"] = tr.span_id
                if tr.parent_id is not None:
                    rec["parent"] = tr.parent_id
        for k, v in fields.items():
            rec[str(k)] = _clean(v)
        line = (json.dumps(rec) + "\n").encode("utf-8", "replace")
        if _max_bytes is not None:
            _maybe_rotate(len(line))
        os.write(_fd, line)          # one write: a line-atomic append
        os.fsync(_fd)
        return True
    except Exception as e:
        try:
            _warn(f"append failed: {type(e).__name__}: {e}")
            disarm()
        except Exception:
            pass
        return False


def _maybe_rotate(incoming: int) -> None:
    """When the next line would push the file past the cap, rename it
    whole to `<path>.1` and reopen a fresh one; a failed rename keeps
    appending."""
    global _fd
    with _state_lock:
        if _fd is None or _path is None or _max_bytes is None:
            return
        try:
            if os.fstat(_fd).st_size + incoming <= _max_bytes:
                return
            os.replace(_path, _path + ".1")
            fd = os.open(_path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                         0o644)
        except OSError:
            return
        try:
            os.close(_fd)
        except OSError:
            pass
        _fd = fd


_bad_names: set = set()


def _warn_once_bad_name(ev: str) -> None:
    with _state_lock:
        if ev in _bad_names:
            return
        _bad_names.add(ev)
    print(f"obs.ledger: dropped event with non-grammar name {ev!r} "
          "(EVENT_NAME_RE)", file=sys.stderr, flush=True)


def arm_session(prog: str, argv=None, **fields) -> Optional[str]:
    """The entry point's hook: arm from the environment, root the trace,
    record `session.start`, and `session.end` at interpreter exit. A
    no-op when no ledger is configured."""
    global _session_open
    path = arm()
    if path is None:
        return None
    try:
        from tpu_reductions_torch.obs import trace
        trace.ensure_root()
    except Exception:
        pass
    emit("session.start", prog=prog,
         argv=list(argv) if argv is not None else None, **fields)
    with _state_lock:
        register = not _session_open
        _session_open = True
    if register:
        atexit.register(_end_session)
    return path


def _end_session() -> None:
    emit("session.end")


def main(argv=None) -> int:
    """Append one event from the command line; key=value fields parse
    numbers."""
    import argparse
    p = argparse.ArgumentParser(
        prog="tpu_reductions_torch.obs.ledger",
        description="Append one event to the flight-recorder ledger")
    p.add_argument("event", help="dotted event name (EVENT_NAME_RE)")
    p.add_argument("fields", nargs="*", help="key=value event fields")
    p.add_argument("--ledger", default=None,
                   help="ledger path (default TPU_REDUCTIONS_LEDGER)")
    p.add_argument("--platform", default="gpu", choices=("gpu", "cpu"))
    ns = p.parse_args(argv)
    from tpu_reductions_torch import device as device_mod
    device_mod.resolve(ns.platform)
    if arm(ns.ledger) is None:
        print("obs.ledger: no ledger configured "
              f"(--ledger or {ENV_PATH})", file=sys.stderr)
        return 1
    fields = {}
    for kv in ns.fields:
        k, _, v = kv.partition("=")
        try:
            fields[k] = int(v)
        except ValueError:
            try:
                fields[k] = float(v)
            except ValueError:
                fields[k] = v
    return 0 if emit(ns.event, **fields) else 1


if __name__ == "__main__":
    sys.exit(main())
