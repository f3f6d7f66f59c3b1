"""The output-row grammar: one definition of every machine-parsed line
the port emits, the port's own copy of tpu_reductions/lint/grammar.py.

Downstream tooling (awk and grep pipelines, the reports, the parity
checks against the JAX package) matches these rows byte for byte: the QA
status markers (reference cuda/shared/inc/shrQATest.h:83-112,224-229),
the throughput line (reduction.cpp:744-745) and the collective row schema
(reduce.c:67-69,81,95). The producers (utils/qa.py, utils/logging.py,
obs/ledger.py) import their templates from here, and the lint's RED005
(lint/rules.py) validates every other string literal of the port against
the same regexes, so the emitters and the checker cannot drift apart.

Standard library only (`re`): the producers import it on every CLI start,
and the lint must run on a machine with neither jax nor a card.
"""

from __future__ import annotations

import re

# --------------------------------------------------------------------------
# QA status markers (shrQATest.h:83-112,224-229)
# --------------------------------------------------------------------------

QA_MARKER = "&&&&"
QA_STATUSES = ("PASSED", "FAILED", "WAIVED")

# the emit templates, format() placeholders, used by utils/qa.py
QA_RUNNING_TEMPLATE = "&&&& RUNNING {name} {args}"
QA_FINISH_TEMPLATE = "&&&& {name} {status}"

QA_RUNNING_RE = re.compile(r"^&&&& RUNNING \S+.*$")
QA_FINISH_RE = re.compile(r"^&&&& \S+ (PASSED|FAILED|WAIVED)$")

# --------------------------------------------------------------------------
# The throughput line (reduction.cpp:744-745), utils/logging.py's
# --------------------------------------------------------------------------

THROUGHPUT_TEMPLATE = (
    "{name}, Throughput = {gbps:.4f} GB/s, Time = {secs:.5f} s, "
    "Size = {n} Elements, NumDevsUsed = {devices}, "
    "Workgroup = {workgroup}")

THROUGHPUT_RE = re.compile(
    r"^(\S+), Throughput = ([0-9.]+) GB/s, Time = ([0-9.eE+-]+) s, "
    r"Size = (\d+) Elements, NumDevsUsed = (\d+), Workgroup = (\d+)$")

# --------------------------------------------------------------------------
# The collective rows (reduce.c:67-69,81,95; getAvgs.sh:7-10)
# --------------------------------------------------------------------------

COLLECTIVE_COLUMNS = ("DATATYPE", "OP", "NODES", "GB/sec")
COLLECTIVE_HEADER = " ".join(COLLECTIVE_COLUMNS)  # "DATATYPE OP NODES GB/sec"

COLLECTIVE_ROW_TEMPLATE = "{dtype} {op} {ranks} {gbps:.3f}"
COLLECTIVE_ROW_RE = re.compile(r"^[A-Z][A-Z0-9]* [A-Z]+ \d+ [0-9.]+$")

# --------------------------------------------------------------------------
# Quant-curve rows (bench/quant_curve.py): one per (op, dtype, bits,
# rank count) cell, the wire reduction against the unquantized ring and
# the measured |err| against its declared bound
# --------------------------------------------------------------------------

QUANT_CURVE_COLUMNS = ("DATATYPE", "OP", "BITS", "NODES", "WIREX",
                       "MAXERR", "BOUND")
QUANT_CURVE_HEADER = " ".join(QUANT_CURVE_COLUMNS)

QUANT_CURVE_ROW_TEMPLATE = ("{dtype} {op} {bits} {ranks} {wirex:.3f} "
                            "{max_err:.3e} {bound:.3e}")
QUANT_CURVE_ROW_RE = re.compile(
    r"^[A-Z][A-Z0-9]* [A-Z]+ \d+ \d+ [0-9.]+ [0-9.e+-]+ [0-9.e+-]+$")

# --------------------------------------------------------------------------
# Family rows (bench/family_spot.py): one per (method, dtype, impl) cell,
# the DATATYPE row with the implementation column and the oracle's verdict
# --------------------------------------------------------------------------

FAMILY_COLUMNS = ("DATATYPE", "OP", "IMPL", "N", "GBPS", "STATUS")
FAMILY_HEADER = " ".join(FAMILY_COLUMNS)

FAMILY_ROW_TEMPLATE = "{dtype} {op} {impl} {n} {gbps:.3f} {status}"
FAMILY_ROW_RE = re.compile(
    r"^[A-Z][A-Z0-9]* [A-Z]+ [a-z][a-z0-9-]* \d+ [0-9.]+ "
    r"(PASSED|FAILED)$")

# --------------------------------------------------------------------------
# Flight-recorder event rows (obs/ledger.py). One JSON object per line,
# its leading keys fixed as {"t": ..., "ev": ..., "pid": ...} so a
# postmortem can key on them as it keys on the rows above. obs/ledger.py
# is the one producer; RED012 (lint/rules.py) flags event-shaped prints
# and writes anywhere else.
# --------------------------------------------------------------------------

# the token RED012 keys on: a literal holding it attempts an event row
EVENT_KEY = '"ev":'

# the causal-identity fields obs/trace.py stamps onto every event: trace
# is the tree, span this node, parent what it nests under. RED012 flags
# them as literal emit keywords outside obs/, and obs/trace_export.py and
# obs/critical_path.py key on exactly these names
TRACE_FIELDS = ("trace", "span", "parent")

# `<trace_id>:<span_id>`, carried into subprocesses (obs/trace.py,
# sched/executor.py)
TRACE_ENV = "TPU_REDUCTIONS_TRACE_CTX"

# legal event names: dotted lowercase (session.start, hb.phase,
# watchdog.exit, ...); obs/ledger.py checks every emit against it
EVENT_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*(?:\.[a-z0-9_]+)*$")

# The vocabulary, by producer. It equals the JAX package's registry name
# for name (tests/test_torch_event_registry.py holds the two together):
# the port's ledger lines are the JAX ledger's for the same emit, so the
# timeline, the trace export and the critical path read either.

# the window scheduler (sched/executor.py, sched/__main__.py)
SCHED_EVENTS = ("sched.plan", "sched.pick", "sched.skip", "sched.done",
                "sched.replan")

# the serving engine (serve/engine.py): one request's trace, enqueue ->
# coalesce -> launch -> verify -> respond, and shed, the engine's
# lifecycle, the streamed and sharded routes and the dedup hit
SERVE_EVENTS = ("serve.start", "serve.enqueue", "serve.coalesce",
                "serve.launch", "serve.verify", "serve.respond",
                "serve.shed", "serve.stop", "serve.stream",
                "serve.shard", "serve.dedup")

# the replica router (serve/router.py): its lifetime, each placement,
# reroute and outcome, and each replica's lifecycle
ROUTE_EVENTS = ("route.start", "route.request", "route.reroute",
                "route.done", "route.stop")
REPLICA_EVENTS = ("replica.spawn", "replica.up", "replica.down")

# the stream (ops/stream.py, bench/stream.py): start -> per-chunk fold
# -> materialization -> end, the serial comparator and the overlap verdict
STREAM_EVENTS = ("stream.start", "stream.chunk", "stream.sync",
                 "stream.serial", "stream.overlap", "stream.end")

# the collectives (collectives/, bench/collective_driver.py,
# bench/quant_curve.py): the registry's selection and the device phase
COLLECTIVE_EVENTS = ("collective.select", "collective.launch",
                     "collective.done")

# the reshard engine (reshard/, bench/reshard_curve.py): the program,
# each primitive's step, the close
RESHARD_EVENTS = ("reshard.plan", "reshard.step", "reshard.done")

# the elastic fleet (serve/autoscale.py): the control loop and its
# actions, and the planned scale-down's drain protocol
AUTOSCALE_EVENTS = ("autoscale.tick", "autoscale.up", "autoscale.down",
                    "autoscale.resume")
DRAIN_EVENTS = ("drain.begin", "drain.wait", "drain.handoff",
                "drain.reshard", "drain.done")

# the fleet journal and its recovery (serve/journal.py,
# serve/router.adopt_fleet)
JOURNAL_EVENTS = ("journal.open", "journal.replay", "journal.record")
ADOPT_EVENTS = ("adopt.begin", "adopt.replica", "adopt.done")

# the compile observatory (obs/compile.py) and the warming pass
# (bench/warm.py)
COMPILE_EVENTS = ("compile.start", "compile.end", "warm.start",
                  "warm.surface", "warm.end")

# the execution core (exec/core.py, exec/cost.py): plan -> launch ->
# done for every launch, and the cost oracle's selection
EXEC_EVENTS = ("exec.plan", "exec.select", "exec.launch", "exec.done")

# the reduction family (ops/family/, bench/family_spot.py)
FAMILY_EVENTS = ("family.cell", "family.serve")

# the rest of the Python producers
CORE_EVENTS = (
    "session.start", "session.end",                    # obs/ledger.py
    "hb.phase",                                        # utils/heartbeat.py
    "staging.start", "staging.chunk", "staging.end",   # utils/staging.py
    "staging.stage",                                   # bench/driver.py
    "chain.trip", "chain.slope", "timing.loop",        # utils/timing.py
    "retry.attempt", "retry.fatal",                    # utils/retry.py
    "watchdog.arm", "watchdog.exit",                   # utils/watchdog.py
    "preflight.verdict",                               # utils/preflight.py
    "resume.decision", "resume.reuse",                 # bench/resume.py
    "artifact.persist",                                # bench/resume.py
    "bench.metric", "bench.outage",                    # the JAX bench.py
    "fault.fire",                                      # faults/inject.py
    "firstrow.mark",                                   # bench/firstrow.py
    "sweep.cell", "sweep.rank",                        # bench/sweep.py
    "trace.cut",                                       # obs/trace.py
)

# the JAX package's shell producer (its scripts/obs_event.sh). The port
# has no shell producer; the names stay registered so that a ledger
# written by a JAX session reads the same here and the two registries
# stay equal
SHELL_EVENTS = (
    "session.start", "session.end", "session.abort", "session.fallback",
    "step.start", "step.end", "trace.cut",
    "watcher.arm", "watcher.fire", "watcher.session_end",
    "watcher.rearm", "watcher.defer", "watcher.retire", "watcher.expire",
    "supervisor.spawn", "supervisor.respawn", "supervisor.retire",
    "supervisor.defer",
)

REGISTERED_EVENTS = frozenset(CORE_EVENTS + SHELL_EVENTS + SCHED_EVENTS
                              + SERVE_EVENTS + STREAM_EVENTS
                              + COMPILE_EVENTS + COLLECTIVE_EVENTS
                              + ROUTE_EVENTS + REPLICA_EVENTS
                              + RESHARD_EVENTS + AUTOSCALE_EVENTS
                              + DRAIN_EVENTS + JOURNAL_EVENTS
                              + ADOPT_EVENTS + EXEC_EVENTS
                              + FAMILY_EVENTS)


def event_registered(name: str) -> bool:
    """Whether an event name is in the registered vocabulary
    (tests/test_torch_event_registry.py holds every literal emit of the
    port to it)."""
    return name in REGISTERED_EVENTS


# one complete ledger line
EVENT_ROW_RE = re.compile(
    r'^\{"t": [0-9]+(?:\.[0-9]+)?, "ev": "[a-z][a-z0-9_.]*", '
    r'"pid": [0-9]+(?:, .*)?\}$')


def looks_like_event(text: str) -> bool:
    """RED012's trigger: does this literal attempt the event-row
    grammar? Pure string logic, as check_literal below."""
    return EVENT_KEY in text


# RED012's second trigger: a printed literal that narrates a compile
# duration ("built in {dt:.1f}s") is the observation obs/compile.py makes
# typed. The pattern wants the word stem and a duration (an interpolated
# field or a digit run against a seconds unit), so prose about compiles
# stays legal while a timing claim goes through compile_span.
COMPILE_TIMING_RE = re.compile(
    r"(?i)compil\w*[^\n]*(?:\x00|\d)(?:s|ms|sec(?:ond)?s?)\b")


def looks_like_compile_timing(text: str) -> bool:
    """RED012's second trigger: does this literal narrate a compile
    duration instead of going through obs/compile.compile_span?"""
    return bool(COMPILE_TIMING_RE.search(text))


# --------------------------------------------------------------------------
# Static conformance (RED005) — validate a string literal that *looks*
# like one of the grammars above without knowing its runtime field
# values. The linter replaces every interpolated f-string field with
# PLACEHOLDER before matching, so templates validate structurally.
# --------------------------------------------------------------------------

PLACEHOLDER = "\x00"
_PH = re.escape(PLACEHOLDER)
_FIELD = rf"(?:{_PH}|\S+)"          # a formatted field or a literal token
_STATUS = rf"(?:{_PH}|PASSED|FAILED|WAIVED|RUNNING)"

_STATIC_QA_RES = (
    re.compile(rf"^&&&& RUNNING(?: {_FIELD})+$"),
    re.compile(rf"^&&&& {_FIELD} {_STATUS}$"),
    re.compile(rf"^&&&& {_STATUS}$"),   # grep-side fragments in tests
)
_STATIC_THROUGHPUT_RE = re.compile(
    rf"^{_FIELD}, Throughput = {_FIELD} GB/s, Time = {_FIELD} s, "
    rf"Size = {_FIELD} Elements, NumDevsUsed = {_FIELD}, "
    rf"Workgroup = {_FIELD}$")


def check_literal(text: str) -> str | None:
    """RED005 core: if `text` (a string literal with interpolations
    replaced by PLACEHOLDER) is an attempt at one of the golden row
    grammars but deviates from it, return an error message; return None
    when the literal either conforms or is unrelated to any grammar.

    Pure string logic so both the AST rule and tests exercise exactly
    the spec this module publishes.
    """
    # Multi-line literals (docstring-ish) are judged line by line: only
    # a line that itself trips a trigger is checked.
    for line in text.splitlines() or [text]:
        msg = _check_line(line)
        if msg:
            return msg
    return None


def _check_line(line: str) -> str | None:
    s = line.strip()
    if "&&&" in s:
        # substring-containment greps ("... PASSED" in out) pass through
        # as long as the &&&&-anchored part parses under the QA grammar
        start = s.index("&&&")
        frag = s[start:]
        if not any(r.match(frag) for r in _STATIC_QA_RES):
            return (f"QA marker literal {line!r} does not match the "
                    f"golden grammar ('{QA_RUNNING_TEMPLATE}' or "
                    f"'{QA_FINISH_TEMPLATE}' with status in "
                    f"{'/'.join(QA_STATUSES)})")
    if "Throughput =" in s:
        if not _STATIC_THROUGHPUT_RE.match(s):
            # consumer-side prefixes ("Reduction, Throughput = " in log)
            # are fine when they are a strict prefix of the template
            plain = THROUGHPUT_TEMPLATE.replace("{name}", s.split(",")[0])
            if not plain.startswith(s) and not s.endswith(PLACEHOLDER):
                return (f"throughput literal {line!r} deviates from the "
                        f"reduction.cpp:744-745 template "
                        f"'{THROUGHPUT_TEMPLATE}'")
    if ("DATATYPE" in s and s != COLLECTIVE_HEADER
            and s != QUANT_CURVE_HEADER and s != FAMILY_HEADER):
        # a literal mentioning the header's lead token must BE one of
        # the registered headers (the collective row schema or the
        # quant-curve / family extensions of it)
        if s.startswith("DATATYPE "):
            return (f"collective header literal {line!r} != golden "
                    f"'{COLLECTIVE_HEADER}' (reduce.c:67-69), "
                    f"'{QUANT_CURVE_HEADER}' (bench/quant_curve.py) or "
                    f"'{FAMILY_HEADER}' (bench/family_spot.py)")
    return None
