"""`python -m tpu_reductions_torch.serve`: the TCP JSON-lines front end.

The counterpart of tpu_reductions/serve/__main__.py. One request object a
line, one response line back:

    {"method": "SUM", "type": "int", "n": 65536, "seed": 1,
     "deadline_s": 2.0}
 ->
    {"request_id": "r000000", "status": "ok", "result": 8355840.0, ...}

and the `{"op": ...}` control plane: `ping`, `drain` (close admission),
`drain_status` (draining, queued, warm keys, stats) and `prewarm`. The
engine runs on the card; without one it raises unless --platform=cpu.
The flight recorder arms from TPU_REDUCTIONS_LEDGER. --devices K gives
the executor K ranks for the shard route, spread over every card of the
host (serve/executor.py); --relay-port gates each launch
on a chaos relay (the replica fleet's modeled round trip).

    python -m tpu_reductions_torch.serve [--port 0] [--port-file PATH] \
        [--platform cpu] [--devices K] [--relay-port P] \
        [--max-seconds S] [engine knobs]
"""

from __future__ import annotations

import argparse
import json
import signal
import socketserver
import sys
import threading
import time

from tpu_reductions_torch.config import PLATFORMS


def _control_response(engine, spec: dict) -> dict:
    """One control op; an unknown op or a malformed spec reports instead
    of raising."""
    op = spec.get("op")
    try:
        if op == "ping":
            return {"op": op, "ok": True}
        if op == "drain":
            engine.begin_drain()
            return {"op": op, "ok": True}
        if op == "drain_status":
            return {"op": op, "ok": True,
                    "draining": bool(getattr(engine, "draining", False)),
                    "queued": engine.queued_depth(),
                    "warm_keys": [list(k)
                                  for k in engine.warm_bucket_keys()],
                    "stats": {k: v for k, v in engine.stats.items()}}
        if op == "prewarm":
            engine.prewarm(spec["method"],
                           spec.get("type", spec.get("dtype", "int")),
                           int(spec["n"]),
                           up_to_batch=int(spec.get("up_to_batch", 1)))
            return {"op": op, "ok": True}
        return {"op": op, "error": f"unknown control op: {op!r}"}
    except (AttributeError, KeyError, TypeError, ValueError) as e:
        return {"op": op, "error": f"{type(e).__name__}: {e}"}


def _make_handler(engine, request_timeout_s: float):
    from tpu_reductions_torch.serve.request import ReduceRequest

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            for raw in self.rfile:
                raw = raw.strip()
                if not raw:
                    continue
                try:
                    spec = json.loads(raw)
                    if isinstance(spec, dict) and "op" in spec:
                        resp = _control_response(engine, spec)
                        self.wfile.write(
                            (json.dumps(resp) + "\n").encode())
                        self.wfile.flush()
                        continue
                    req = ReduceRequest(
                        method=spec["method"],
                        dtype=spec.get("type", spec.get("dtype", "int")),
                        n=int(spec.get("n", 1 << 16)),
                        seed=int(spec.get("seed", 0)),
                        deadline_s=spec.get("deadline_s"),
                        value=float(spec.get("value", 1.0)),
                        tenant=spec.get("tenant", "default"),
                        priority=int(spec.get("priority", 1)),
                        slo=spec.get("slo"),
                        idem_key=spec.get("idem_key"))
                except (KeyError, TypeError, ValueError) as e:
                    resp = {"status": "rejected",
                            "error": f"malformed request: {e}"}
                else:
                    try:
                        resp = engine.submit(req).result(
                            timeout=request_timeout_s).to_dict()
                    except TimeoutError as e:
                        resp = {"status": "error", "error": str(e)}
                self.wfile.write((json.dumps(resp) + "\n").encode())
                self.wfile.flush()

    return Handler


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


def main(argv=None) -> int:
    """Start the engine, serve JSON lines until --max-seconds (or an
    interrupt), drain on the way out."""
    p = argparse.ArgumentParser(
        prog="tpu_reductions_torch.serve",
        description="Reduction as a service: TCP JSON-lines front end "
                    "over the serving engine")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="0 = a port from the OS (printed and written to "
                        "--port-file)")
    p.add_argument("--port-file", default=None,
                   help="write the bound port here once listening")
    p.add_argument("--max-queue", type=int, default=64)
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--coalesce-window-ms", type=float, default=5.0)
    p.add_argument("--device-window-ms", type=float, default=250.0)
    p.add_argument("--request-timeout-s", type=float, default=600.0,
                   help="per-connection wait bound on one response")
    p.add_argument("--max-seconds", type=float, default=None,
                   help="total runtime bound (default: until killed)")
    p.add_argument("--platform", default="gpu", choices=PLATFORMS)
    p.add_argument("--devices", dest="num_devices", type=int,
                   default=None,
                   help="ranks of the shard route: a request over the "
                        "shard threshold is split into this many shards, "
                        "folded in rank-ordered blocks on every card of "
                        "the host and combined on the first (default 1: "
                        "oversized requests stream)")
    p.add_argument("--relay-port", type=int, default=None,
                   help="gate launches against this relay port (a "
                        "router parent's chaos relay: every replica pays "
                        "the same modeled round trip)")
    ns = p.parse_args(argv)
    if ns.num_devices is not None and ns.num_devices < 1:
        p.error("--devices must be positive")

    from tpu_reductions_torch import device as device_mod
    device_mod.resolve(ns.platform)      # no card, no server
    # SIGINT drains the engine through KeyboardInterrupt, even when this
    # process was started with SIGINT ignored (a router's reap sends it)
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGINT, signal.default_int_handler)
    from tpu_reductions_torch.obs.ledger import arm_session
    arm_session("serve", argv=list(argv) if argv else sys.argv[1:])
    from tpu_reductions_torch.exec.core import maybe_arm
    maybe_arm(ns.platform)

    from tpu_reductions_torch.serve.engine import ServeEngine
    from tpu_reductions_torch.serve.executor import BatchExecutor
    transport = None
    if ns.relay_port is not None:
        from tpu_reductions_torch.serve.transport import RelayTransport
        transport = RelayTransport(ports=(ns.relay_port,),
                                   assume_tunneled=True, drain=True)
    engine = ServeEngine(
        max_queue=ns.max_queue, max_batch=ns.max_batch,
        coalesce_window_s=ns.coalesce_window_ms / 1e3,
        device_window_s=ns.device_window_ms / 1e3,
        executor=BatchExecutor(ns.platform, ranks=ns.num_devices or 1),
        transport=transport, platform=ns.platform).start()

    server = _Server((ns.host, ns.port),
                     _make_handler(engine, ns.request_timeout_s))
    port = server.server_address[1]
    print(f"serving on {ns.host}:{port}", flush=True)
    if ns.port_file:
        from tpu_reductions_torch.utils.jsonio import atomic_text_dump
        atomic_text_dump(ns.port_file, f"{port}\n")
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        if ns.max_seconds is None:
            while True:
                time.sleep(0.5)
        else:
            time.sleep(ns.max_seconds)
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()
        t.join()
        engine.stop(drain=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
