"""Per-function fact seeding for the port lint's flow layer, re-seeded for
torch and CUDA (the counterpart of tpu_reductions/lint/flow/facts.py,
whose fact names and meanings it keeps; DRAINS, RED007's marker, does
not carry, since a local card's context ends with its process):

* TOUCHES_DEVICE — work on the card: a torch.cuda call other than a
  query (rules.CUDA_QUERIES), ``torch.cuda.synchronize``, Stream/Event/
  CUDAGraph construction and a graph's ``.replay()`` (ops/chain.py), a
  ``.cuda()``/``.to(<device>)`` copy, a torch call given a card
  ``device=`` (an allocation on the card), a torch.distributed data call,
  the
  ctypes wrappers of ops/_cuda.py (k6_reduce ... dd_reduce) and its
  ``build``/``library``, which load the nvcc-built library. Queries
  (``torch.cuda.is_available``, ``device_count``, ``get_device_name``,
  ``device.resolve``) are not touches: the watchdog arms once the device
  is known, and a local card has no relay whose init can hang;
* DISPATCH — the subset that queues work on the card or waits for it —
  RED019's object: a synchronize, a graph replay, a copy, a distributed
  data call, a kernel wrapper. Constructing a Stream, Event or
  CUDAGraph, an allocation (``device=``), loading the library and the
  other torch.cuda calls touch the card but queue no work, as the JAX
  layer's bare ``jax.jit(f)`` touches the backend without dispatching;
* SYNC — a host wait on the card: ``torch.cuda.synchronize``,
  ``device.synchronize``, ``Event``/``Stream.synchronize()`` — RED018's
  and RED023's object. ``.item()``, ``.cpu()`` and ``.tolist()`` do not
  seed SYNC (docs/PORT.md, "Mechanics and limits");
* GATES — ``maybe_arm`` (utils/watchdog.py, re-exported by exec/core.py),
  ``run_preflight`` and ``gate_verdict`` (utils/preflight.py);
* GUARDS — ``heartbeat.tick``/``heartbeat.guard``, ``exec_core.run``
  (every LaunchPlan runs under its declared heartbeat phase) and the
  builder's ``ctx.tick``/``ctx.guard`` (exec/core.py);
* RETRIES — ``retry_device_call`` (utils/retry.py), ``exec_core.run``
  and the builder's ``ctx.call``;
* STAGES — the bounded host->device surfaces: ``device_put_chunked``,
  ``maybe_chunked_stage``, ``ChunkStager`` (utils/staging.py),
  ``run_stream``/``StreamReducer`` (ops/stream.py), and any call into
  those two modules;
* INGESTS — RED015's host->device spellings, aliases resolved;
* WALLCLOCK — ``time.perf_counter``/``time.monotonic`` call sites.

Recognition is by spelling (last component or dotted chain, resolved
target or literal), so fixture trees without the real modules seed the
same; `.to` is read through the call site's device_arg flag
(callgraph.py), since only its argument tells a copy from a cast.
"""

from __future__ import annotations

from typing import Set

from tpu_reductions_torch.lint.flow.callgraph import CallSite, ModuleInfo
from tpu_reductions_torch.lint.rules import (CUDA_QUERIES, DIST_DATA_CALLS,
                                             GATE_NAMES, INGEST_CTORS,
                                             KERNEL_LOADERS, KERNEL_WRAPPERS)

TOUCHES_DEVICE = "TOUCHES_DEVICE"
DISPATCH = "DISPATCH"
SYNC = "SYNC"
GATES = "GATES"
GUARDS = "GUARDS"
RETRIES = "RETRIES"
STAGES = "STAGES"
INGESTS = "INGESTS"
WALLCLOCK = "WALLCLOCK"

# bump to invalidate cached per-file facts when recognizers change
FACTS_SCHEMA_VERSION = 1

_CUDA_CTORS = {"Stream", "Event", "CUDAGraph"}
_RETRY_NAMES = {"retry_device_call"}
_STAGE_NAMES = {"device_put_chunked", "maybe_chunked_stage",
                "ChunkStager", "run_stream", "StreamReducer"}
_STAGE_MODULES = ("utils.staging", "ops.stream")
_WALLCLOCK_TARGETS = {"time.perf_counter", "time.monotonic"}

_WORK = frozenset({TOUCHES_DEVICE, DISPATCH})


def classify_call(site: CallSite) -> Set[str]:
    """The fact set one call site seeds (on the function containing
    it). Judged on the resolved target when a binding resolved it, on
    the literal chain otherwise — both spellings land in the same fact."""
    facts: Set[str] = set()
    names = {site.target, site.raw} - {""}
    # a device= keyword is device work on torch's own constructors only
    # (torch.zeros(..., device=dev)); ReduceConfig(device=...) just
    # carries the choice. The resolved target sees through aliases.
    torch_call = any(n.startswith("torch.") for n in names)
    if site.device_arg == "move":
        facts |= _WORK | {INGESTS}
    elif site.device_arg == "arg" and torch_call:
        facts.add(TOUCHES_DEVICE)
        if names & INGEST_CTORS:
            facts |= _WORK | {INGESTS}
    for name in names:
        owner, _, last = name.rpartition(".")
        if name.startswith("torch.cuda."):
            if last not in CUDA_QUERIES:
                facts.add(TOUCHES_DEVICE)
            if last == "synchronize":
                facts |= _WORK | {SYNC}
        elif last == "synchronize":
            # device.synchronize(dev), event.synchronize(),
            # stream.synchronize()
            facts |= _WORK | {SYNC}
        if last in _CUDA_CTORS and owner.endswith("cuda"):
            facts.add(TOUCHES_DEVICE)
        if last == "replay" and "graph" in owner.lower():
            facts |= _WORK
        if last in DIST_DATA_CALLS and owner == "torch.distributed":
            facts |= _WORK
        if last in KERNEL_WRAPPERS and "_cuda" in owner:
            facts |= _WORK
        if last in KERNEL_LOADERS and owner.endswith("_cuda"):
            facts.add(TOUCHES_DEVICE)
        if last in GATE_NAMES:
            facts.add(GATES)
        if last in ("tick", "guard") and "heartbeat" in name:
            facts.add(GUARDS)
        if last in _RETRY_NAMES:
            facts.add(RETRIES)
        # the execution core: run(plan) executes every LaunchPlan under
        # its declared resilience contract, the heartbeat guard and the
        # bounded retry both inside exec/core.run
        if last == "run" and ("exec_core" in name or "exec.core" in name):
            facts |= {GUARDS, RETRIES}
        # the builder's LaunchContext surface (exec/core.py): builders
        # receive `ctx` by convention; ctx.guard/ctx.tick delegate to
        # utils.heartbeat, ctx.call to utils.retry
        if name.startswith("ctx."):
            if last in ("tick", "guard"):
                facts.add(GUARDS)
            elif last == "call":
                facts.add(RETRIES)
        if last in _STAGE_NAMES or \
                any(m in name for m in _STAGE_MODULES):
            facts.add(STAGES)
        if name in _WALLCLOCK_TARGETS:
            facts.add(WALLCLOCK)
    return facts


def seed_module(mi: ModuleInfo) -> None:
    """Annotate every function in `mi` with the facts its call sites
    seed (idempotent: clears previous seeds first)."""
    for fi in mi.functions.values():
        fi.facts = {}
        for site in fi.calls:
            for fact in classify_call(site):
                fi.add_fact(fact, site.line)
