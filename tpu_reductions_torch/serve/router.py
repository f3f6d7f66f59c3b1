"""The replica router: the scale-out tier over N serving engines.

The counterpart of tpu_reductions/serve/router.py. One `ReplicaRouter`
fronts N replicas, in-process `LocalReplica` engines (the load
generator's fast path) or `ProcessReplica` children (`python -m
tpu_reductions_torch.serve` over the TCP JSON-lines wire), and routes
each request:

  * bucket affinity: a request at or under `affinity_bytes` hashes on
    (method, dtype, n) with zlib.crc32, the JAX router's hash, so the
    same key picks the same replica as in JAX and one replica's warm
    buckets serve every recurrence of it;
  * balance: everything else goes to the alive replica with the fewest
    outstanding requests;
  * re-routing: a terminal response that blames the replica (dead
    process, dead relay, stopped engine) is resubmitted to another alive
    replica up to `max_retries` times, and a draining replica's refusal
    is resubmitted without spending a retry, so every routed request
    still resolves to exactly one terminal status.

On the card (docs/PORT.md "The fleet on one card"): N `ProcessReplica`
children are N processes, each with a CUDA context of its own, that
time-share one H100; N `LocalReplica` engines are N worker threads
launching on the same card. No replica has a card of its own. The router
moves requests, never payloads: device work happens inside the replicas.

CLI (the process-per-replica tier in one command):

    python -m tpu_reductions_torch.serve.router --replicas 2 \
        [--port 0 --port-file PATH] [--platform cpu] [--devices K] \
        [--relay-port P] [--journal PATH] [--autoscale]
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import queue
import signal
import socket
import subprocess
import sys
import threading
import time
import zlib
from typing import Dict, List, Optional, Sequence

from tpu_reductions_torch.faults.inject import fault_point
from tpu_reductions_torch.obs import ledger, trace
from tpu_reductions_torch.serve.journal import FleetJournal
from tpu_reductions_torch.serve.request import (PendingResponse,
                                                ReduceRequest,
                                                ReduceResponse)

# substrings of a terminal response's error that blame the replica, not
# the request: the re-route predicate (a failed verification or an
# expired deadline would fail the same anywhere)
_REPLICA_FAILURE_MARKS = ("replica-dead", "replica-timeout",
                          "relay dead", "relay-dead", "engine-stopped")

# the planned scale-down refusal, deliberately not a failure: a draining
# replica is healthy, so landing on one re-routes without spending a
# retry
_REPLICA_DRAINING_MARK = "replica-draining"


def replica_failure(resp: ReduceResponse) -> bool:
    """Whether this terminal response blames the replica rather than the
    request: the router's re-route predicate."""
    if resp.status not in ("error", "shed", "rejected"):
        return False
    return any(m in (resp.error or "") for m in _REPLICA_FAILURE_MARKS)


def replica_draining(resp: ReduceResponse) -> bool:
    """Whether this terminal response is a draining replica declining new
    work (serve/engine.begin_drain's refusal): re-routed without spending
    a retry."""
    if resp.status not in ("error", "shed", "rejected"):
        return False
    return _REPLICA_DRAINING_MARK in (resp.error or "")


def _is_draining(replica) -> bool:
    """Duck-typed draining probe: a replica without the drain protocol
    never drains."""
    probe = getattr(replica, "draining", None)
    return bool(probe()) if callable(probe) else False


class LocalReplica:
    """One in-process engine behind the router: a worker thread on the
    engine's device, no spawn and no TCP hop."""

    def __init__(self, replica_id: str, engine) -> None:
        self.replica_id = replica_id
        self._engine = engine

    def start(self) -> "LocalReplica":
        self._engine.start()
        ledger.emit("replica.up", replica=self.replica_id, kind="local")
        return self

    def alive(self) -> bool:
        e = self._engine
        return (e._thread is not None and e._thread.is_alive()
                and not e._stopping)

    def submit(self, request: ReduceRequest) -> PendingResponse:
        return self._engine.submit(request)

    def prewarm(self, method: str, dtype: str, n: int, *,
                up_to_batch: int = 1) -> None:
        """The engine's bucket warmer."""
        self._engine.prewarm(method, dtype, n, up_to_batch=up_to_batch)

    # -- drain protocol (serve/autoscale.drain_replica) ---------------

    def drain_begin(self) -> None:
        """Close admission for a planned scale-down; queued and in-flight
        work keeps serving (serve/engine.begin_drain)."""
        self._engine.begin_drain()

    def draining(self) -> bool:
        return bool(self._engine.draining)

    def queued_depth(self) -> int:
        return self._engine.queued_depth()

    def warm_bucket_keys(self) -> list:
        return self._engine.warm_bucket_keys()

    def slo_p99(self, slo: str):
        return self._engine.slo_p99(slo)

    def stats(self) -> dict:
        """The engine's terminal counters (a drained victim retires with
        shed == 0)."""
        return dict(self._engine.stats)

    def stop(self) -> None:
        self._engine.stop(drain=True)

    def kill(self) -> None:
        """Chaos seam: stop without drain (the queue sheds), the
        in-process stand-in for a replica process dying."""
        ledger.emit("replica.down", replica=self.replica_id,
                    reason="killed")
        self._engine.stop(drain=False)


class ProcessReplica:
    """One `python -m tpu_reductions_torch.serve` child behind the router:
    its own interpreter, CUDA context and engine, talked to over the TCP
    JSON-lines wire by a small worker pool, so `submit` never blocks. A
    dead child or connection resolves every affected request with a
    `replica-dead` error, which the router's re-route predicate catches.

    The child runs on the card unless `platform="cpu"`; a child that
    cannot reach the card exits, and `start()` raises with the tail of
    its standard error. `spawn_s` is the seconds the child took to
    publish its port."""

    def __init__(self, replica_id: str, *, platform: str = "gpu",
                 relay_port: Optional[int] = None,
                 devices: Optional[int] = None, workers: int = 4,
                 request_timeout_s: float = 600.0,
                 spawn_timeout_s: float = 90.0,
                 reap_grace_s: float = 5.0,
                 extra_args: Sequence[str] = ()) -> None:
        self.replica_id = replica_id
        self._platform = platform
        self._relay_port = relay_port
        self._devices = devices
        self._workers = workers
        self._request_timeout_s = request_timeout_s
        self._spawn_timeout_s = spawn_timeout_s
        self._reap_grace_s = reap_grace_s
        self._extra_args = list(extra_args)
        self._proc: Optional[subprocess.Popen] = None
        self._pid: Optional[int] = None    # adopted orphans: no Popen
        self._port: Optional[int] = None
        self._jobs: "queue.Queue" = queue.Queue()
        self._threads: List[threading.Thread] = []
        self._down_emitted = False
        self._draining_flag = False
        self._lock = threading.Lock()
        self.spawn_s: Optional[float] = None

    @classmethod
    def adopt(cls, replica_id: str, *, port: int, pid: int,
              platform: str = "gpu",
              relay_port: Optional[int] = None, workers: int = 4,
              request_timeout_s: float = 600.0,
              reap_grace_s: float = 5.0) -> "ProcessReplica":
        """Re-attach to a running child a dead controller left behind
        (the journal's port and pid): no Popen handle (the orphan was
        reparented when the old router died), so liveness falls back to
        signal-0 probes and reaping to os.kill escalation. `start()` only
        builds the worker pool."""
        rep = cls(replica_id, platform=platform, relay_port=relay_port,
                  workers=workers, request_timeout_s=request_timeout_s,
                  reap_grace_s=reap_grace_s)
        rep._pid = int(pid)
        rep._port = int(port)
        return rep

    @property
    def pid(self) -> Optional[int]:
        return self._proc.pid if self._proc is not None else self._pid

    @property
    def port(self) -> Optional[int]:
        return self._port

    @property
    def adopted(self) -> bool:
        return self._proc is None and self._pid is not None

    def start(self) -> "ProcessReplica":
        if self.adopted:
            self._start_workers()
            ledger.emit("replica.up", replica=self.replica_id,
                        kind="adopted", port=self._port, pid=self._pid)
            return self
        import shutil
        import tempfile
        port_dir = tempfile.mkdtemp(prefix="replica-")
        port_file = os.path.join(port_dir, "port")
        cmd = [sys.executable, "-m", "tpu_reductions_torch.serve",
               "--port", "0", "--port-file", port_file]
        if self._platform:
            cmd += ["--platform", self._platform]
        if self._devices is not None:
            cmd += ["--devices", str(self._devices)]
        if self._relay_port is not None:
            cmd += ["--relay-port", str(self._relay_port)]
        cmd += self._extra_args
        t0 = time.monotonic()
        # the child's standard error goes to a file of the spawn's own
        # directory, read back only when the spawn fails
        # redlint: disable=RED010 -- the child's stderr handed to Popen, read back only when its spawn fails; nothing replays it, so a torn file loses diagnostics only
        with open(os.path.join(port_dir, "stderr"), "wb") as err:
            self._proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                          stderr=err)
        ledger.emit("replica.spawn", replica=self.replica_id,
                    pid=self._proc.pid)
        try:
            deadline = t0 + self._spawn_timeout_s
            while time.monotonic() < deadline:
                if self._proc.poll() is not None:
                    raise RuntimeError(
                        f"replica {self.replica_id} died during spawn "
                        f"(exit {self._proc.returncode}): "
                        f"{_tail(os.path.join(port_dir, 'stderr'))}")
                try:
                    with open(port_file) as f:
                        self._port = int(f.read().strip())
                    break
                except (OSError, ValueError):
                    time.sleep(0.05)
            if self._port is None:
                self._proc.kill()
                raise TimeoutError(
                    f"replica {self.replica_id} never published its "
                    f"port within {self._spawn_timeout_s}s")
        finally:
            shutil.rmtree(port_dir, ignore_errors=True)
        self.spawn_s = time.monotonic() - t0
        self._start_workers()
        ledger.emit("replica.up", replica=self.replica_id,
                    kind="process", port=self._port)
        return self

    def _start_workers(self) -> None:
        for i in range(self._workers):
            t = threading.Thread(target=self._worker, daemon=True,
                                 name=f"{self.replica_id}-w{i}")
            t.start()
            self._threads.append(t)

    def alive(self) -> bool:
        if self._proc is not None:
            return self._proc.poll() is None
        if self._pid is None:
            return False
        # an adopted orphan has no waitable handle: signal 0 probes it
        try:
            os.kill(self._pid, 0)
            return True
        except (ProcessLookupError, PermissionError):
            return False

    def ping(self) -> bool:
        """A control round trip: a pid can live while the engine inside
        is wedged, and only a response proves the replica serves."""
        return self._control({"op": "ping"}).get("ok") is True

    def submit(self, request: ReduceRequest) -> PendingResponse:
        pending = PendingResponse(f"{self.replica_id}-pending")
        if not self.alive():
            self._mark_down("process-exited")
            pending.resolve(ReduceResponse(
                pending.request_id, "error", request.method,
                request.dtype, request.n,
                error=f"replica-dead: {self.replica_id} not running"))
            return pending
        self._jobs.put((request, pending))
        return pending

    def _worker(self) -> None:
        """One connection, one blocking round trip at a time. A dead
        process, a refused or broken connection or a read timeout
        resolves the request in flight with a replica-dead (or
        replica-timeout) error; the job queue never drops a request."""
        import json
        conn = None
        rfile = None
        while True:
            item = self._jobs.get()
            if item is None:
                break
            request, pending = item
            try:
                if conn is None:
                    conn = socket.create_connection(
                        ("127.0.0.1", self._port), timeout=5.0)
                    conn.settimeout(self._request_timeout_s)
                    rfile = conn.makefile("rb")
                spec = {"method": request.method, "type": request.dtype,
                        "n": request.n, "seed": request.seed,
                        "deadline_s": request.deadline_s,
                        "value": request.value,
                        "tenant": request.tenant,
                        "priority": request.priority,
                        "slo": request.slo,
                        "idem_key": request.idem_key}
                conn.sendall((json.dumps(spec) + "\n").encode())
                raw = rfile.readline()
                if not raw:
                    raise ConnectionError("connection closed mid-request")
                d = json.loads(raw)
                pending.resolve(ReduceResponse(
                    d.get("request_id", pending.request_id),
                    d.get("status", "error"), request.method,
                    request.dtype, request.n,
                    result=d.get("result"), error=d.get("error"),
                    latency_s=d.get("latency_s"),
                    queue_s=d.get("queue_s"),
                    batch_size=d.get("batch_size"), cards=d.get("cards")))
            except socket.timeout:
                self._drop_conn(conn)
                conn = rfile = None
                pending.resolve(ReduceResponse(
                    pending.request_id, "error", request.method,
                    request.dtype, request.n,
                    error=(f"replica-timeout: {self.replica_id} gave "
                           f"no response in {self._request_timeout_s}s")))
            except (OSError, ValueError) as e:   # ConnectionError too
                self._drop_conn(conn)
                conn = rfile = None
                self._mark_down(f"{type(e).__name__}: {e}")
                pending.resolve(ReduceResponse(
                    pending.request_id, "error", request.method,
                    request.dtype, request.n,
                    error=(f"replica-dead: {self.replica_id} "
                           f"({type(e).__name__}: {e})")))
        self._drop_conn(conn)

    @staticmethod
    def _drop_conn(conn) -> None:
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    def _mark_down(self, reason: str) -> None:
        with self._lock:
            if self._down_emitted:
                return
            self._down_emitted = True
        ledger.emit("replica.down", replica=self.replica_id,
                    reason=reason[:120])

    # -- drain protocol (serve/autoscale.drain_replica) ---------------

    def _control(self, spec: dict) -> dict:
        """One {"op": ...} round trip on a short connection of its own;
        a failure reports instead of raising (a child dead mid-drain is
        the kill case, not a crash)."""
        import json
        try:
            with socket.create_connection(("127.0.0.1", self._port),
                                          timeout=10.0) as conn:
                conn.sendall((json.dumps(spec) + "\n").encode())
                raw = conn.makefile("rb").readline()
            return json.loads(raw) if raw else {"error": "no response"}
        except (OSError, ValueError) as e:
            return {"error": f"{type(e).__name__}: {e}"}

    def drain_begin(self) -> None:
        resp = self._control({"op": "drain"})
        with self._lock:
            self._draining_flag = not resp.get("error")

    def draining(self) -> bool:
        with self._lock:
            return self._draining_flag

    def queued_depth(self) -> int:
        return int(self._control({"op": "drain_status"}
                                 ).get("queued") or 0)

    def warm_bucket_keys(self) -> list:
        keys = self._control({"op": "drain_status"}).get("warm_keys")
        return [tuple(k) for k in keys] if keys else []

    def slo_p99(self, slo: str):
        return None      # per-class tails stay in the child

    def stats(self) -> dict:
        return self._control({"op": "drain_status"}).get("stats") or {}

    def prewarm(self, method: str, dtype: str, n: int, *,
                up_to_batch: int = 1) -> None:
        self._control({"op": "prewarm", "method": method, "type": dtype,
                       "n": int(n), "up_to_batch": int(up_to_batch)})

    def stop(self) -> None:
        for _ in self._threads:
            self._jobs.put(None)
        self.reap()

    def reap(self) -> Optional[str]:
        """INT first with a bounded grace before escalating: SIGINT lets
        the child drain its engine, SIGTERM after `reap_grace_s`, SIGKILL
        another grace later. Returns the signal that ended it, or None
        when it was already gone (the adoption probe's evidence)."""
        if not self.alive():
            return None
        for sig_name, sig_no in (("int", signal.SIGINT),
                                 ("term", signal.SIGTERM),
                                 ("kill", signal.SIGKILL)):
            try:
                if self._proc is not None:
                    self._proc.send_signal(sig_no)
                else:
                    os.kill(self._pid, sig_no)
            except OSError:     # ProcessLookupError, PermissionError
                return None
            deadline = time.monotonic() + self._reap_grace_s
            while time.monotonic() < deadline:
                if not self.alive():
                    return sig_name
                time.sleep(0.05)
        return "kill"

    def kill(self) -> None:
        """Chaos seam: SIGKILL the child mid-traffic; round trips in
        flight fail to replica-dead and the router re-routes them."""
        self._mark_down("killed")
        if self._proc is not None:
            if self._proc.poll() is None:
                self._proc.kill()
        elif self._pid is not None:
            try:
                os.kill(self._pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass


def _tail(path: str, limit: int = 600) -> str:
    """The last `limit` characters of a file, one line."""
    try:
        with open(path, errors="replace") as f:
            text = f.read()
    except OSError:
        return ""
    return " ".join(text[-limit:].split())


@dataclasses.dataclass
class _Routed:
    """One routed request in flight."""

    request: ReduceRequest
    router_id: str
    pending: PendingResponse          # the router's own slot
    t_submit: float
    attempts: int = 0
    tried: tuple = ()


class ReplicaRouter:
    """The scale-out front end (module docstring), interface-compatible
    with ServeEngine where the front ends care: `submit(request) ->
    PendingResponse`, `start()`, `stop()`, `stats`."""

    def __init__(self, replicas: Sequence, *,
                 affinity_bytes: int = 1 << 20,
                 max_retries: int = 2,
                 journal: Optional[FleetJournal] = None) -> None:
        if not replicas:
            raise ValueError("need at least one replica")
        self._replicas = list(replicas)
        self._affinity_bytes = affinity_bytes
        self._max_retries = max_retries
        # the write-ahead journal (serve/journal.py): in memory without a
        # path, so every fleet mutation journals unconditionally
        self._journal = journal if journal is not None \
            else FleetJournal(None)
        self._outstanding: Dict[str, int] = {
            r.replica_id: 0 for r in self._replicas}
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self.stats: Dict[str, int] = {
            "routed": 0, "rerouted": 0, "drain_rerouted": 0,
            "affinity": 0, "balanced": 0, "no_replica": 0}

    @property
    def journal(self) -> FleetJournal:
        return self._journal

    def _journal_replica(self, replica, state: str) -> None:
        """Journal one transition with whatever identity the replica
        exposes (ProcessReplica: port and pid; LocalReplica: its name, for
        the narrative: it dies with the controller)."""
        self._journal.record_replica(
            replica.replica_id, state=state,
            port=getattr(replica, "port", None),
            pid=getattr(replica, "pid", None),
            platform=getattr(replica, "_platform", None),
            relay_port=getattr(replica, "_relay_port", None))

    # -- lifecycle ----------------------------------------------------

    def start(self) -> "ReplicaRouter":
        for r in self._replicas:
            if not getattr(r, "adopted", False):
                # write-ahead: the journal knows the child before it
                # exists
                self._journal_replica(r, "starting")
            r.start()
            self._journal_replica(r, "up")
        ledger.emit("route.start", replicas=len(self._replicas),
                    affinity_bytes=self._affinity_bytes,
                    max_retries=self._max_retries)
        return self

    def stop(self) -> None:
        for r in self._replicas:
            self._journal_replica(r, "down")
            r.stop()
            self._journal.forget_replica(r.replica_id)
        ledger.emit("route.stop", **{k: int(v)
                                     for k, v in self.stats.items()})

    @property
    def replicas(self) -> List:
        return list(self._replicas)

    # -- elastic fleet (serve/autoscale.py) ---------------------------

    def add_replica(self, replica) -> None:
        """Scale-up seam: start the replica and admit it to routing,
        journaled "starting" before the spawn and "up" after."""
        if not getattr(replica, "adopted", False):
            self._journal_replica(replica, "starting")
        replica.start()
        with self._lock:
            self._replicas.append(replica)
            self._outstanding.setdefault(replica.replica_id, 0)
        self._journal_replica(replica, "up")

    def remove_replica(self, replica_id: str) -> None:
        """Scale-down seam: forget a replica after its drain completed;
        late results from it tolerate the missing outstanding row."""
        self._journal.record_replica(replica_id, state="down")
        with self._lock:
            self._replicas = [r for r in self._replicas
                              if r.replica_id != replica_id]
            self._outstanding.pop(replica_id, None)
        self._journal.forget_replica(replica_id)

    def load_snapshot(self) -> dict:
        """The autoscaler's per-tick observable: per-replica outstanding,
        alive and draining flags, and the routing stats."""
        with self._lock:
            outstanding = dict(self._outstanding)
            stats = dict(self.stats)
            replicas = [{"replica": r.replica_id, "alive": r.alive(),
                         "draining": _is_draining(r)}
                        for r in self._replicas]
        return {"outstanding": outstanding, "stats": stats,
                "replicas": replicas}

    def affinity_target(self, method: str, dtype: str, n: int,
                        exclude: tuple = ()):
        """The replica a bucket key hashes to once `exclude` (a drain's
        victim) is gone: where a handoff prewarms the key (the hash of
        `_pick`)."""
        with self._lock:
            alive = [r for r in self._replicas
                     if r.replica_id not in exclude and r.alive()
                     and not _is_draining(r)]
        if not alive:
            return None
        key = f"{method}:{dtype}:{n}"
        return alive[zlib.crc32(key.encode()) % len(alive)]

    # -- routing ------------------------------------------------------

    def submit(self, request: ReduceRequest) -> PendingResponse:
        """Route one request; the PendingResponse always resolves (the
        replicas' no-hang contract, and the no-replica-alive error)."""
        # chaos seam: a scripted `exit` here is a controller death
        # mid-burst (os._exit: no drain, no atexit; the children orphan
        # alive with the journal as their only record)
        fault_point("router.crash")
        rid = f"g{next(self._ids):06d}"
        pending = PendingResponse(rid)
        routed = _Routed(request=request, router_id=rid,
                         pending=pending, t_submit=time.monotonic())
        self._dispatch(routed)
        return pending

    def _pick(self, request: ReduceRequest, tried: tuple):
        """(replica, policy) among alive replicas not yet tried for this
        request; (None, None) when none qualify."""
        with self._lock:
            alive = [r for r in self._replicas
                     if r.replica_id not in tried and r.alive()
                     and not _is_draining(r)]
            if not alive:
                return None, None
            if request.nbytes <= self._affinity_bytes:
                key = f"{request.method}:{request.dtype}:{request.n}"
                idx = zlib.crc32(key.encode()) % len(alive)
                return alive[idx], "affinity"
            return min(alive, key=lambda r: self._outstanding[
                r.replica_id]), "balanced"

    def _dispatch(self, routed: _Routed) -> None:
        replica, policy = self._pick(routed.request, routed.tried)
        if replica is None:
            self.stats["no_replica"] += 1
            self._finish(routed, None, ReduceResponse(
                routed.router_id, "error", routed.request.method,
                routed.request.dtype, routed.request.n,
                error=("no-replica-alive: all replicas dead or "
                       "already tried for this request")))
            return
        routed.attempts += 1
        routed.tried += (replica.replica_id,)
        self.stats["routed"] += 1
        self.stats[policy] += 1
        if policy == "affinity":
            # the bucket placement (deduped inside): what recovery
            # re-prewarms
            r = routed.request
            self._journal.record_placement(r.method, r.dtype, r.n)
        with self._lock:
            self._outstanding[replica.replica_id] += 1
        ledger.emit("route.request", req=routed.router_id,
                    replica=replica.replica_id, policy=policy,
                    attempt=routed.attempts,
                    **trace.request_fields(routed.router_id))
        inner = replica.submit(routed.request)
        inner.add_done_callback(
            lambda resp, rep=replica: self._on_result(routed, rep, resp))

    def _on_result(self, routed: _Routed, replica,
                   resp: ReduceResponse) -> None:
        with self._lock:
            if replica.replica_id in self._outstanding:
                self._outstanding[replica.replica_id] = max(
                    0, self._outstanding[replica.replica_id] - 1)
        if replica_draining(resp):
            # a planned scale-down is no failure: re-route without
            # spending an attempt; `tried` keeps the victim, so an
            # all-draining fleet ends at no-replica-alive
            routed.attempts -= 1
            self.stats["drain_rerouted"] += 1
            ledger.emit("route.reroute", req=routed.router_id,
                        replica=replica.replica_id,
                        attempt=routed.attempts,
                        reason=(resp.error or "")[:120],
                        **trace.request_fields(routed.router_id))
            self._dispatch(routed)
            return
        if replica_failure(resp) \
                and routed.attempts <= self._max_retries:
            self.stats["rerouted"] += 1
            ledger.emit("route.reroute", req=routed.router_id,
                        replica=replica.replica_id,
                        attempt=routed.attempts,
                        reason=(resp.error or "")[:120],
                        **trace.request_fields(routed.router_id))
            self._dispatch(routed)
            return
        self._finish(routed, replica, resp)

    def _finish(self, routed: _Routed, replica,
                resp: ReduceResponse) -> None:
        out = dataclasses.replace(
            resp, request_id=routed.router_id,
            latency_s=round(time.monotonic() - routed.t_submit, 6))
        ledger.emit("route.done", req=routed.router_id,
                    replica=(replica.replica_id if replica else None),
                    status=out.status, latency_s=out.latency_s,
                    attempts=routed.attempts,
                    **trace.request_fields(routed.router_id))
        routed.pending.resolve(out)


def adopt_fleet(journal: FleetJournal, *,
                request_timeout_s: float = 600.0,
                reap_grace_s: float = 5.0):
    """Recover a dead controller's fleet from its journal: probe every
    journaled replica over the TCP wire and split the fleet into
    (adopted, reaped): children that still serve come back as
    `ProcessReplica.adopt` handles; the rest (never came up, pid gone,
    wedged engine) are reaped INT first and forgotten. `adopt.done`'s
    wall_s is the controller's time to recover."""
    entries = journal.replicas()
    t0 = time.monotonic()
    ledger.emit("adopt.begin", candidates=len(entries))
    adopted: List[ProcessReplica] = []
    reaped: List[str] = []
    for name in sorted(entries):
        entry = entries[name]
        port, pid = entry.get("port"), entry.get("pid")
        if port is None or pid is None or entry.get("state") == "down":
            # never came up, or already retired: nothing to probe
            verdict = "stale"
            journal.forget_replica(name)
        else:
            rep = ProcessReplica.adopt(
                name, port=int(port), pid=int(pid),
                platform=entry.get("platform") or "gpu",
                relay_port=entry.get("relay_port"),
                request_timeout_s=request_timeout_s,
                reap_grace_s=reap_grace_s)
            if rep.alive() and rep.ping():
                verdict = "adopted"
                adopted.append(rep)
            else:
                sig = rep.reap()
                verdict = f"reaped-{sig}" if sig else "gone"
                reaped.append(name)
                journal.forget_replica(name)
        ledger.emit("adopt.replica", replica=name, verdict=verdict,
                    port=port, pid=pid)
    ledger.emit("adopt.done", adopted=len(adopted), reaped=len(reaped),
                wall_s=round(time.monotonic() - t0, 6))
    return adopted, reaped


def reprewarm_placements(router: ReplicaRouter) -> int:
    """Re-prewarm every journaled affinity placement onto the replica the
    current alive set hashes it to; returns how many were warmed."""
    warmed = 0
    for method, dtype, n in router.journal.placements():
        target = router.affinity_target(method, dtype, int(n))
        if target is None:
            continue
        try:
            target.prewarm(method, dtype, int(n))
            warmed += 1
        except (OSError, ValueError, RuntimeError):
            continue
    return warmed


def local_router(n_replicas: int, *, engine_kwargs: Optional[dict] = None,
                 affinity_bytes: int = 1 << 20,
                 max_retries: int = 2) -> ReplicaRouter:
    """N in-process engine replicas behind one router; each engine can be
    handed its own transport through engine_kwargs['transports']."""
    from tpu_reductions_torch.serve.engine import ServeEngine
    kwargs = dict(engine_kwargs or {})
    transports = kwargs.pop("transports", None)
    replicas = []
    for i in range(n_replicas):
        kw = dict(kwargs)
        if transports is not None:
            kw["transport"] = transports[i]
        replicas.append(LocalReplica(f"replica-{i}", ServeEngine(**kw)))
    return ReplicaRouter(replicas, affinity_bytes=affinity_bytes,
                         max_retries=max_retries)


def main(argv=None) -> int:
    """Spawn N `python -m tpu_reductions_torch.serve` children, route over
    them, and serve the single engine's TCP JSON-lines wire."""
    import argparse

    from tpu_reductions_torch.config import PLATFORMS, fleet_journal_path

    p = argparse.ArgumentParser(
        prog="tpu_reductions_torch.serve.router",
        description="Replica router over process-per-replica serving "
                    "engines")
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="0 = a port from the OS (printed and written to "
                        "--port-file)")
    p.add_argument("--port-file", default=None)
    p.add_argument("--affinity-bytes", type=int, default=1 << 20,
                   help="requests at or under this hash-route for bucket "
                        "affinity; larger ones load-balance")
    p.add_argument("--max-retries", type=int, default=2,
                   help="re-route attempts after a replica failure")
    p.add_argument("--request-timeout-s", type=float, default=600.0)
    p.add_argument("--max-seconds", type=float, default=None)
    p.add_argument("--platform", default="gpu", choices=PLATFORMS)
    p.add_argument("--devices", type=int, default=None,
                   help="every replica's shard-route ranks, spread "
                        "over the host's cards (serve --devices)")
    p.add_argument("--relay-port", type=int, default=None,
                   help="every replica gates launches on this relay "
                        "port (faults/relay.py)")
    p.add_argument("--journal", default=None,
                   help="fleet journal path (default: "
                        "TPU_REDUCTIONS_FLEET_JOURNAL, else in memory). "
                        "A restart against a journal a dead controller "
                        "left behind re-adopts its live children, reaps "
                        "the rest INT first, resumes the autoscaler "
                        "mid-cooldown and re-prewarms the journaled "
                        "placements")
    p.add_argument("--autoscale", action="store_true",
                   help="run the autoscaler over the fleet "
                        "(serve/autoscale.py), its state journaled each "
                        "tick and resumed on restart")
    ns = p.parse_args(argv)
    if ns.replicas <= 0:
        p.error("--replicas must be positive")

    from tpu_reductions_torch import device as device_mod
    device_mod.resolve(ns.platform)      # no card, no fleet
    # SIGINT stops the fleet through KeyboardInterrupt, even when this
    # process was started with SIGINT ignored
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGINT, signal.default_int_handler)
    ledger.arm_session("serve.router",
                       argv=list(argv) if argv else sys.argv[1:])
    from tpu_reductions_torch.exec.core import maybe_arm
    maybe_arm(ns.platform)

    journal = FleetJournal(fleet_journal_path(ns.journal))
    adopted, _ = adopt_fleet(
        journal, request_timeout_s=ns.request_timeout_s) \
        if journal.replicas() else ([], [])

    def spawn(i: int) -> ProcessReplica:
        return ProcessReplica(f"replica-{i}", platform=ns.platform,
                              relay_port=ns.relay_port,
                              devices=ns.devices,
                              request_timeout_s=ns.request_timeout_s)

    taken = {r.replica_id for r in adopted}
    replicas: List = list(adopted)
    i = 0
    while len(replicas) < ns.replicas:
        if f"replica-{i}" not in taken:
            replicas.append(spawn(i))
        i += 1
    router = ReplicaRouter(replicas, affinity_bytes=ns.affinity_bytes,
                           max_retries=ns.max_retries, journal=journal)
    autoscaler = None
    server = None
    try:
        router.start()
        if adopted:
            reprewarm_placements(router)
        if ns.autoscale:
            from tpu_reductions_torch.serve.autoscale import Autoscaler
            from tpu_reductions_torch.serve.executor import BatchExecutor
            autoscaler = Autoscaler(
                router, spawn, journal=journal,
                executor=BatchExecutor(ns.platform,
                                       ranks=ns.devices or 1))
            autoscaler.restore_state(journal.autoscaler_state())
            autoscaler.start()

        from tpu_reductions_torch.serve.__main__ import (_make_handler,
                                                         _Server)
        server = _Server((ns.host, ns.port),
                         _make_handler(router, ns.request_timeout_s))
        port = server.server_address[1]
        spawns = ", ".join(
            f"{r.replica_id} " + ("adopted" if r.spawn_s is None
                                  else f"{r.spawn_s:.2f}")
            for r in replicas)
        print(f"routing {ns.replicas} replicas on {ns.host}:{port} "
              f"(spawn s: {spawns})", flush=True)
        if ns.port_file:
            from tpu_reductions_torch.utils.jsonio import atomic_text_dump
            atomic_text_dump(ns.port_file, f"{port}\n")
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        if ns.max_seconds is None:
            while True:
                time.sleep(0.5)
        else:
            time.sleep(ns.max_seconds)
    except KeyboardInterrupt:
        pass
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        if autoscaler is not None:
            autoscaler.stop()
        # every child started so far is reaped, a failed spawn included
        router.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
