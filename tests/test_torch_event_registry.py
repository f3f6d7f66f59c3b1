"""The port's event-name drift gate, the counterpart of
tests/test_event_registry.py: every literal `emit("...")` name in the port
and in chip_smoke.py is in the port's registry
(tpu_reductions_torch/lint/grammar.py REGISTERED_EVENTS), and that registry
equals the JAX package's, so a ledger either package writes reads the same
in both."""

import ast
from pathlib import Path

import pytest

from tpu_reductions.lint import grammar as jax_grammar
from tpu_reductions_torch.lint import grammar
from tpu_reductions_torch.obs.trace_export import OPENER_CLOSERS

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "tpu_reductions_torch"
PY_FILES = sorted(f for f in PORT.rglob("*.py")
                  if "_build" not in f.parts) + [REPO / "chip_smoke.py"]


def _chain(node):
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _emit_calls():
    for f in PY_FILES:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Call) and \
                    _chain(node.func).rsplit(".", 1)[-1] == "emit":
                yield f.relative_to(REPO).as_posix(), node


def _literal_sites():
    """(path, line, name) of every emit with a literal event name. Names
    built at run time (the spans helper's `name + '.start'`, the ledger
    CLI's argument) are checked against EVENT_NAME_RE by the ledger."""
    return [(path, node.lineno, node.args[0].value)
            for path, node in _emit_calls()
            if node.args and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)]


def test_every_literal_emit_is_registered():
    sites = _literal_sites()
    assert len(sites) >= 90, "the scanner found too few emit sites"
    missing = [s for s in sites if not grammar.event_registered(s[2])]
    assert missing == [], (
        f"emit() names missing from lint/grammar.py: {missing} — add "
        "them to the matching *_EVENTS tuple")


def test_the_sites_cover_every_producer():
    """The port's producers of events: each subpackage that emits has a
    literal site the scan sees."""
    dirs = {Path(p).parts[1] for p, _, _ in _literal_sites()
            if p.startswith("tpu_reductions_torch/")}
    assert {"obs", "utils", "bench", "serve", "sched", "exec", "ops",
            "faults"} <= dirs, dirs


def test_the_registry_equals_the_jax_registry():
    """No name is registered on one side only: the port emits the JAX
    package's vocabulary and nothing else (no extra name needs a reason)."""
    assert grammar.REGISTERED_EVENTS == jax_grammar.REGISTERED_EVENTS
    for name in ("SCHED_EVENTS", "SERVE_EVENTS", "ROUTE_EVENTS",
                 "REPLICA_EVENTS", "STREAM_EVENTS", "COLLECTIVE_EVENTS",
                 "RESHARD_EVENTS", "AUTOSCALE_EVENTS", "DRAIN_EVENTS",
                 "JOURNAL_EVENTS", "ADOPT_EVENTS", "COMPILE_EVENTS",
                 "EXEC_EVENTS", "FAMILY_EVENTS", "CORE_EVENTS",
                 "SHELL_EVENTS", "TRACE_FIELDS", "TRACE_ENV", "EVENT_KEY"):
        assert getattr(grammar, name) == getattr(jax_grammar, name), name


@pytest.mark.parametrize("pattern", ["EVENT_NAME_RE", "EVENT_ROW_RE",
                                     "COMPILE_TIMING_RE", "QA_RUNNING_RE",
                                     "QA_FINISH_RE", "THROUGHPUT_RE",
                                     "COLLECTIVE_ROW_RE",
                                     "QUANT_CURVE_ROW_RE", "FAMILY_ROW_RE"])
def test_the_row_patterns_equal_the_jax_patterns(pattern):
    assert getattr(grammar, pattern).pattern == \
        getattr(jax_grammar, pattern).pattern


def test_registered_names_conform_to_the_name_grammar():
    bad = sorted(n for n in grammar.REGISTERED_EVENTS
                 if not grammar.EVENT_NAME_RE.match(n))
    assert bad == []


def test_every_registered_opener_has_a_registered_closer():
    unclosed = sorted(
        n for n in grammar.REGISTERED_EVENTS
        if n.endswith(".start")
        and n[:-len(".start")] + ".end" not in grammar.REGISTERED_EVENTS
        and n not in OPENER_CLOSERS)
    assert unclosed == []
    assert sorted(c for c in OPENER_CLOSERS.values()
                  if c not in grammar.REGISTERED_EVENTS) == []


def test_no_emit_outside_obs_mints_trace_fields():
    offenders = [(path, node.lineno) for path, node in _emit_calls()
                 if not path.startswith("tpu_reductions_torch/obs/")
                 and any(kw.arg in grammar.TRACE_FIELDS
                         for kw in node.keywords)]
    assert offenders == []


def test_the_trace_env_is_the_one_obs_reads():
    from tpu_reductions_torch.obs import trace
    assert trace.ENV_CTX == grammar.TRACE_ENV
