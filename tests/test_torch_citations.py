"""The port's citations of the JAX package hold: every `file:line` that a
docstring in the port's measured packages (ops/, bench/) gives into the
JAX package (`tpu_reductions/...`, its `scripts/` and its root
`bench.py`) names a file that exists and a line within it, and in a
`def`'s or a `class`'s docstring a cited line of Python begins a `def` or
a `class`. The JAX package is frozen, so a line once right stays right.
The docstrings that state "no reference analog" instead are pinned by
name, so that a citation cannot be dropped quietly."""

import ast
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "tpu_reductions_torch"
MEASURED = ("ops", "bench")

CITATION_RE = re.compile(
    r"(?<![\w/.])((?:tpu_reductions|scripts)/[\w./-]+\.\w+|bench\.py)"
    r":(\d+)(?:-(\d+))?")
NO_ANALOG_RE = re.compile(r"no reference analog", re.I)
DEF_RE = re.compile(r"\s*(?:async\s+def|def|class)\s")

# the port-native docstrings: the card-only probes, the ctypes loader and
# the torch spellings the JAX package has no need of
NO_ANALOG = [
    "bench/host.py",
    "bench/host.py::time_staging",
    "bench/host.py::time_oracle",
    "bench/host.py::main",
    # the rank axis across cards, held against one card: the JAX package
    # has no placement twin
    "bench/collective_driver.py::bits_required",
    "bench/collective_driver.py::chain_agrees",
    "bench/multicard.py",
    "bench/multicard.py::chain_scalar",
    "bench/multicard.py::digest",
    "bench/multicard.py::free_port",
    "bench/multicard.py::launch",
    "bench/multicard.py::main",
    "bench/multicard.py::run_group",
    "bench/multicard.py::same_bits",
    "bench/multicard.py::twin",
    "bench/multicard.py::twins",
    "bench/multicard.py::within_tolerance",
    # the rank ladder across cards: the JAX mesh takes every device, and
    # holds no one-card twin
    "bench/collective_driver.py::link_share",
    "bench/multicard.py::LadderFailed",
    "bench/multicard.py::Witness",
    "bench/multicard.py::Witness.collective",
    "bench/multicard.py::Witness.keep",
    "bench/multicard.py::Witness.record",
    "bench/multicard.py::host_cards",
    "bench/multicard.py::ladder_agrees",
    "bench/multicard.py::reporting",
    "bench/multicard.py::run_ladder",
    "bench/multicard.py::rung_done",
    "bench/multicard.py::shared_checkpoint",
    "bench/multicard.py::spawns",
    "bench/rank_scaling.py::placement",
    # the drain across cards, held against one card: the JAX drain's
    # mesh spans the chips with no one-card twin
    "bench/drain_cards.py",
    "bench/drain_cards.py::check_drain",
    "bench/drain_cards.py::drain_fleet",
    "bench/drain_cards.py::drain_rows",
    "bench/drain_cards.py::failures",
    "bench/drain_cards.py::summary",
    "bench/passes.py",
    "bench/passes.py::bits",
    "bench/passes.py::device_ms",
    "bench/passes.py::kernel_profile",
    "bench/passes.py::profile_k6_k7",
    "bench/passes.py::host_ms",
    "bench/passes.py::profile_dd",
    "bench/passes.py::profile_k8",
    "bench/passes.py::flusher",
    "bench/passes.py::cold_us",
    "bench/passes.py::l2_probe",
    "bench/passes.py::profile_k9_k10",
    "bench/passes.py::print_profile",
    "bench/passes.py::time_cases",
    "bench/passes.py::time_race_k7",
    "bench/passes.py::time_k8_k10_k9_dd",
    "bench/passes.py::sweep_plans",
    "bench/passes.py::sweep_k9_k10",
    "bench/passes.py::sweep_k8",
    "bench/passes.py::sweep_dd",
    "bench/passes.py::main",
    "ops/_cuda.py",
    "ops/_cuda.py::build",
    "ops/_cuda.py::Card",
    "ops/_cuda.py::card",
    "ops/_cuda.py::library",
    "ops/_cuda.py::span_active_clusters",
    "ops/_cuda.py::spin_ns",
    "ops/chain.py::counted_wrappers",
    "ops/chain.py::ChainedReduce.close",
    "ops/chain.py::ChainedReduce.eager",
    "ops/kernel_reduce.py::target_device",
    "ops/oracle.py::host_value",
    "ops/registry.py::torch_dtype",
    "ops/stream.py::dtype_name",
]


def measured_files():
    return sorted(p for p in PORT.rglob("*.py")
                  if set(p.relative_to(PORT).parts[:-1]) & set(MEASURED))


def docstrings(path: Path):
    """(name, is a def or class, docstring) of the module and of every
    def and class in it, nested ones included; names as in NO_ANALOG."""
    rel = path.relative_to(PORT).as_posix()
    tree = ast.parse(path.read_text())
    out = [(rel, False, ast.get_docstring(tree, clean=False))]

    def walk(node, prefix):
        for n in node.body:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                out.append((f"{rel}::{prefix}{n.name}", True,
                            ast.get_docstring(n, clean=False)))
                walk(n, f"{prefix}{n.name}.")

    walk(tree, "")
    return [(name, is_def, doc) for name, is_def, doc in out if doc]


@pytest.mark.parametrize("path", measured_files(),
                         ids=lambda p: p.relative_to(PORT).as_posix())
def test_every_citation_names_a_line_that_exists(path):
    bad = []
    for name, is_def, doc in docstrings(path):
        for m in CITATION_RE.finditer(doc):
            target = REPO / m.group(1)
            first = int(m.group(2))
            last = int(m.group(3) or first)
            if not target.is_file():
                bad.append(f"{name}: {m.group(0)}: no such file")
                continue
            lines = target.read_text().splitlines()
            if not 1 <= first <= last <= len(lines):
                bad.append(f"{name}: {m.group(0)}: past the end of "
                           f"{len(lines)} lines")
            elif is_def and target.suffix == ".py" \
                    and not DEF_RE.match(lines[first - 1]):
                bad.append(f"{name}: {m.group(0)}: not a def or class: "
                           f"{lines[first - 1].strip()!r}")
    assert bad == [], "\n".join(bad)


def test_the_no_analog_docstrings_are_the_pinned_ones():
    found = [name for path in measured_files()
             for name, _, doc in docstrings(path) if NO_ANALOG_RE.search(doc)]
    assert sorted(found) == sorted(NO_ANALOG)


def test_the_citation_pattern_reads_what_it_must():
    text = ("tpu_reductions/ops/oracle.py:94, bench.py:163, "
            "scripts/run_rank_scaling.sh:22-129; not "
            "tpu_reductions_torch/ops/oracle.py:1 nor reduction.cpp:665")
    assert [m.group(0) for m in CITATION_RE.finditer(text)] == [
        "tpu_reductions/ops/oracle.py:94", "bench.py:163",
        "scripts/run_rank_scaling.sh:22-129"]


def test_the_module_docstrings_cite_their_counterpart():
    """A module with a same-named counterpart in the JAX package cites
    that file."""
    missing = []
    for path in measured_files():
        rel = path.relative_to(PORT).as_posix()
        twin = REPO / "tpu_reductions" / rel
        doc = ast.get_docstring(ast.parse(path.read_text()), clean=False)
        if twin.is_file() and f"tpu_reductions/{rel}:" not in (doc or ""):
            missing.append(rel)
    assert missing == []
