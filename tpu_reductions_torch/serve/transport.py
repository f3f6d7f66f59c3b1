"""The per-launch transport gate.

The counterpart of tpu_reductions/serve/transport.py. Before each launch
the engine calls `transport.gate()`, which returns the seconds it cost or
raises `TransportDead`. A card in the machine has no relay, so the
engine's default is `NullTransport`, the gate that never gates.

`RelayTransport` is the relay gate: one bounded round trip to a relay
before each launch. In the port it only models a launch's round trip:
pointed at the chaos relay (faults/relay.py) in `slow` mode, each launch
pays the relay's delay, which is what the load generator's
--launch-latency-ms and the elastic drain-versus-kill pair use.

  * every probe port refuses -> `TransportDead`: the engine sheds
    instead of dispatching;
  * a `slow` relay holds the connection for its delay; draining to EOF
    makes the delay land here;
  * a stalled relay (accepts, never closes) is bounded by `read_cap_s`.

Without the relay marker (utils/watchdog.tunneled_environment) and
without explicit ports the gate is free. Drain-to-EOF runs only when the
ports are explicit or TPU_REDUCTIONS_RELAY_PORTS names them.
"""

from __future__ import annotations

import os
import socket
import time
from typing import Optional

from tpu_reductions_torch.serve.request import TransportDead
from tpu_reductions_torch.utils import heartbeat
from tpu_reductions_torch.utils.watchdog import (resolved_ports,
                                                 tunneled_environment)


class RelayTransport:
    """The relay gate (module docstring)."""

    def __init__(self, *, connect_timeout_s: float = 2.0,
                 read_cap_s: float = 5.0,
                 drain: Optional[bool] = None,
                 ports: Optional[tuple] = None,
                 assume_tunneled: bool = False) -> None:
        """`drain=None` drains to EOF only when the ports are explicit or
        env-overridden; True/False force it. `ports` with
        `assume_tunneled` bind the gate to one relay (the load
        generator's modeled round trip) without the environment."""
        self._connect_timeout_s = connect_timeout_s
        self._read_cap_s = read_cap_s
        self._drain = drain
        self._ports = tuple(ports) if ports is not None else None
        self._assume_tunneled = assume_tunneled

    def _should_drain(self) -> bool:
        if self._drain is not None:
            return self._drain
        if self._ports is not None:
            return True
        return bool(os.environ.get("TPU_REDUCTIONS_RELAY_PORTS"))

    def _gated(self) -> bool:
        return self._assume_tunneled or tunneled_environment()

    def _resolved_ports(self):
        return self._ports if self._ports is not None \
            else resolved_ports()

    def gate(self) -> float:
        """One bounded relay round trip; the seconds it cost. Raises
        TransportDead when every probe port refuses. Ungated: free. Runs
        under a heartbeat guard, like any other transport wait."""
        if not self._gated():
            return 0.0
        t0 = time.monotonic()
        inconclusive = False
        # redlint: disable=RED025 -- guards a raw TCP port probe (no device work); there is no launch to plan, only a socket wait to watch
        with heartbeat.guard("serve"):
            for port in self._resolved_ports():
                try:
                    with socket.create_connection(
                            ("127.0.0.1", port),
                            timeout=self._connect_timeout_s) as s:
                        if self._should_drain():
                            s.settimeout(self._read_cap_s)
                            try:
                                while s.recv(1024):
                                    heartbeat.tick()
                            except OSError:
                                # a stall is bounded here (timeouts are
                                # OSErrors too)
                                pass
                    return time.monotonic() - t0
                except (ConnectionRefusedError, ConnectionResetError,
                        socket.timeout, TimeoutError):
                    continue
                except OSError:
                    # local degradation (EMFILE and the like) says nothing
                    # about the relay: passable, never dead
                    inconclusive = True
        if inconclusive:
            return time.monotonic() - t0
        raise TransportDead(
            "relay refuses on every probe port "
            f"({','.join(map(str, self._resolved_ports()))})")


class NullTransport:
    """A gate that never gates: the engine's default on a local card."""

    def gate(self) -> float:
        return 0.0
