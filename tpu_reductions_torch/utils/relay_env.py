"""The relay endpoint's defaults: one source for every prober.

The counterpart of tpu_reductions/utils/relay_env.py: the default relay
ports and marker, the comma-separated spelling of the ports, and the two
environment overrides (`TPU_REDUCTIONS_RELAY_PORTS`,
`TPU_REDUCTIONS_RELAY_MARKER`) that utils/watchdog.py and
utils/preflight.py resolve through. Stdlib only, importing nothing of
the package, so it runs standalone (`python -S`) too.

A card in the machine is reached without a relay, so the port has no
default marker: a host counts as tunneled only when
TPU_REDUCTIONS_RELAY_MARKER names a file that exists (the chaos harness
points it at one; faults/relay.py stands in for the relay).
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

# the relay's TCP ports (the JAX package's defaults)
DEFAULT_RELAY_PORTS: Tuple[int, ...] = (8082, 8083)
# no default marker on a local card (module docstring)
DEFAULT_RELAY_MARKER = ""


def ports_str(ports: Sequence[int] = DEFAULT_RELAY_PORTS) -> str:
    """The comma-separated spelling TPU_REDUCTIONS_RELAY_PORTS uses."""
    return ",".join(str(p) for p in ports)


def env_ports() -> Tuple[int, ...]:
    """The probed ports: TPU_REDUCTIONS_RELAY_PORTS when set, else the
    defaults."""
    env = os.environ.get("TPU_REDUCTIONS_RELAY_PORTS")
    if env:
        return tuple(int(p) for p in env.split(",") if p.strip())
    return DEFAULT_RELAY_PORTS


def env_marker() -> str:
    """The marker file: TPU_REDUCTIONS_RELAY_MARKER when set, else the
    default ('' : none)."""
    return os.environ.get("TPU_REDUCTIONS_RELAY_MARKER",
                          DEFAULT_RELAY_MARKER)
