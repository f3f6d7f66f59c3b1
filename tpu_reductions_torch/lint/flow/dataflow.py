"""Fixpoint propagation and the interprocedural rules RED017-RED020 of
the port lint (the counterpart of tpu_reductions/lint/flow/dataflow.py;
the propagation is the same, the facts are torch's, flow/facts.py).

Summaries computed per function node, to a fixpoint over the call
graph (monotone booleans + set-once witness chains, so recursion
terminates):

* ``device_reach``   — TOUCHES_DEVICE somewhere in the subtree;
* ``sync_reach``     — a host wait on the card in the subtree;
* ``gates_internally`` — a GATES call anywhere in the function or a
  resolved callee (the "calling this function arms the gate" summary);
* ``ungated_device`` — scanning the function's call sites in line
  order, a device touch is reachable BEFORE any GATES node has run
  (the interprocedural generalization of RED011's gate-precedes-touch
  scan);
* ``unguarded_dispatch`` — device work (DISPATCH) reachable on a chain
  carrying neither a GUARDS (heartbeat) nor a RETRIES node;
* ``staged``         — the function stages through the bounded-transfer
  surfaces (utils/staging.py / ops/stream.py).

Rules (docs/PORT.md, "The lint on the port"):

* RED017 — an entry point (any ``if __name__ == "__main__"`` guard)
  whose transitive execution can touch the card before the watchdog's
  gate (maybe_arm / run_preflight / gate_verdict) runs;
* RED018 — a call inside a perf_counter/monotonic window whose callee
  transitively waits on the card (synchronize) — the helper-syncs-
  inside-someone-else's-window case RED002 cannot see;
* RED019 — an entry point reaching device work on a path with no
  heartbeat guard and no bounded retry anywhere on the chain: a kernel
  that never returns hangs it with nothing to end it;
* RED020 — a host->device copy reachable from an entry point with no
  STAGES node on the path, where the per-file RED015 fence does not
  already apply (files outside RED015's scope dirs).

A content-hash per-file fact cache (.lint_cache_torch.json by default,
written through utils/jsonio.atomic_json_dump) makes warm runs
re-extract only changed files; the propagation itself always runs (it
is cross-file and cheap).
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from tpu_reductions_torch.lint import rules as _rules
from tpu_reductions_torch.lint.conc import analysis as C_analysis
from tpu_reductions_torch.lint.conc import extract as C
from tpu_reductions_torch.lint.flow import facts as F
from tpu_reductions_torch.lint.flow.callgraph import (ModuleInfo, Project,
                                                      extract_module,
                                                      module_name_for)
from tpu_reductions_torch.lint.rules import RawFinding, _suffix_match

# cache schema: bumped together with the fact-schema versions it keys
# on; the version stamp ALSO carries a content fingerprint of the lint
# package itself (schema_fingerprint) so ANY lint upgrade — new
# recognizer, new rule, changed propagation — invalidates cached facts
# instead of silently reusing them.
CACHE_SCHEMA = 2


@dataclass
class Summary:
    """Per-function propagated state (all transitions monotone)."""
    device_reach: bool = False
    sync_reach: bool = False
    gates_internally: bool = False
    staged: bool = False
    protected: bool = False
    ungated_device: Optional[Tuple[int, Tuple[str, ...]]] = None
    unguarded_dispatch: Optional[Tuple[int, Tuple[str, ...]]] = None
    site_facts: Dict[int, frozenset] = field(default_factory=dict)


def _node_label(project: Project, fqn: str) -> str:
    mi, fi = project.nodes[fqn]
    return f"{mi.module}.{fi.qualname}"


def compute_summaries(project: Project) -> Dict[str, Summary]:
    """Iterate the whole graph to a fixpoint. Unresolvable call sites
    contribute their own seeded facts but are never propagated over —
    recorded, not dropped (callgraph.py docstring contract)."""
    summaries: Dict[str, Summary] = {}
    resolved_callee: Dict[str, List[Tuple[int, Optional[str], frozenset]]] \
        = {}
    for fqn, (mi, fi) in project.nodes.items():
        s = Summary()
        sites = []
        for cs in fi.calls:
            cf = frozenset(F.classify_call(cs))
            callee = project.resolve_target(cs.target) if cs.target \
                else None
            if callee == fqn:
                callee = None            # direct recursion: no new info
            sites.append((cs.line, callee, cf))
            s.site_facts[cs.line] = s.site_facts.get(
                cs.line, frozenset()) | cf
        resolved_callee[fqn] = sites
        s.protected = bool({F.GUARDS, F.RETRIES}
                           & set(fi.facts.keys()))
        s.staged = F.STAGES in fi.facts
        summaries[fqn] = s

    changed = True
    passes = 0
    while changed and passes < 100:
        changed = False
        passes += 1
        for fqn in project.nodes:
            s = summaries[fqn]
            gated = False
            for line, callee, cf in resolved_callee[fqn]:
                cal = summaries.get(callee) if callee else None
                if F.TOUCHES_DEVICE in cf and not s.device_reach:
                    s.device_reach = changed = True
                if F.SYNC in cf and not s.sync_reach:
                    s.sync_reach = changed = True
                if F.GATES in cf and not s.gates_internally:
                    s.gates_internally = changed = True
                if cal is not None:
                    if cal.device_reach and not s.device_reach:
                        s.device_reach = changed = True
                    if cal.sync_reach and not s.sync_reach:
                        s.sync_reach = changed = True
                    if cal.gates_internally and not s.gates_internally:
                        s.gates_internally = changed = True
                # --- ordered gate scan (RED017) ---
                if F.GATES in cf:
                    gated = True
                if not gated and s.ungated_device is None:
                    if F.TOUCHES_DEVICE in cf:
                        s.ungated_device = (line, ())
                        changed = True
                    elif cal is not None and cal.ungated_device \
                            is not None:
                        s.ungated_device = (
                            line, (_node_label(project, callee),)
                            + cal.ungated_device[1])
                        changed = True
                if cal is not None and cal.gates_internally:
                    gated = True
                # --- unguarded dispatch (RED019) ---
                if not s.protected and s.unguarded_dispatch is None:
                    if F.DISPATCH in cf:
                        s.unguarded_dispatch = (line, ())
                        changed = True
                    elif cal is not None and cal.unguarded_dispatch \
                            is not None:
                        s.unguarded_dispatch = (
                            line, (_node_label(project, callee),)
                            + cal.unguarded_dispatch[1])
                        changed = True
    return summaries


def _chain_text(frames: Tuple[str, ...]) -> str:
    return " -> ".join(frames) if frames else "a direct call here"


def _red017(project: Project, summaries: Dict[str, Summary]
            ) -> Dict[str, List[RawFinding]]:
    out: Dict[str, List[RawFinding]] = {}
    for fqn in project.entries():
        mi, _ = project.nodes[fqn]
        s = summaries[fqn]
        if s.ungated_device is None:
            continue
        line, frames = s.ungated_device
        out.setdefault(mi.rel, []).append(RawFinding(
            "RED017", line,
            "entry point reaches a device touch with no watchdog gate "
            "on the path (via "
            f"{_chain_text(frames)}) — a kernel that hangs in its "
            "synchronize is never ended unless the watchdog is armed; "
            "call utils.watchdog.maybe_arm (or the utils.preflight "
            "gate) before any device-reaching call"))
    return out


def _red019(project: Project, summaries: Dict[str, Summary]
            ) -> Dict[str, List[RawFinding]]:
    out: Dict[str, List[RawFinding]] = {}
    for fqn in project.entries():
        mi, _ = project.nodes[fqn]
        s = summaries[fqn]
        if s.unguarded_dispatch is None:
            continue
        line, frames = s.unguarded_dispatch
        out.setdefault(mi.rel, []).append(RawFinding(
            "RED019", line,
            "entry point reaches device work with neither a "
            "heartbeat guard nor a bounded retry on the path (via "
            f"{_chain_text(frames)}) — a launch that stalls mid-run "
            "leaves no phase for the watchdog to attribute its exit 4 "
            "to; run the work through exec.core.run (or a ctx.guard/"
            "ctx.call), or utils.heartbeat's guard"))
    return out


def _red018(project: Project, summaries: Dict[str, Summary]
            ) -> Dict[str, List[RawFinding]]:
    out: Dict[str, List[RawFinding]] = {}
    for fqn, (mi, fi) in project.nodes.items():
        if _suffix_match(mi.rel, _rules.TIMING_WHITELIST):
            continue
        wall = fi.facts.get(F.WALLCLOCK, [])
        if len(wall) < 2:
            continue                      # no window, just a clock read
        if F.SYNC in fi.facts:
            continue                      # in-function sync: RED002's
        lo, hi = min(wall), max(wall)
        s = summaries[fqn]
        for cs in fi.calls:
            if not (lo <= cs.line <= hi) or not cs.target:
                continue
            callee = project.resolve_target(cs.target)
            if callee is None:
                continue
            cal = summaries[callee]
            if cal.sync_reach:
                out.setdefault(mi.rel, []).append(RawFinding(
                    "RED018", cs.line,
                    f"call to {_node_label(project, callee)} inside a "
                    "perf_counter/monotonic timing window reaches a "
                    "card synchronize — the host clock adds launch, "
                    "Python and host jitter to the card's time; take "
                    "the time from utils/timing.py (CUDA events, the "
                    "chained slope) or hoist the helper out of the "
                    "window"))
                break                     # one finding per window
    return out


def _red015_covered(rel: str) -> bool:
    """True when the per-file RED015 fence already judges the file's
    ingest spellings (the same device_ingest spellings: RED020 defers to
    it and its reason-waivers)."""
    parts = rel.split("/")
    return bool(set(_rules.STAGE_INGEST_SCOPE_DIRS) & set(parts[:-1]))


def _red020(project: Project, summaries: Dict[str, Summary]
            ) -> Dict[str, List[RawFinding]]:
    # forward pass: nodes reachable from an entry along a chain with no
    # STAGES node (the chain INCLUDES both endpoints)
    reach: Dict[str, Tuple[str, ...]] = {}
    work = []
    for fqn in project.entries():
        if not summaries[fqn].staged:
            reach[fqn] = (_node_label(project, fqn),)
            work.append(fqn)
    while work:
        fqn = work.pop()
        for cs in project.nodes[fqn][1].calls:
            callee = project.resolve_target(cs.target) if cs.target \
                else None
            if callee is None or callee in reach:
                continue
            if summaries[callee].staged:
                continue
            reach[callee] = reach[fqn] + (_node_label(project, callee),)
            work.append(callee)

    out: Dict[str, List[RawFinding]] = {}
    for fqn, frames in reach.items():
        mi, fi = project.nodes[fqn]
        if _suffix_match(mi.rel, _rules.STAGE_INGEST_WHITELIST):
            continue                      # the sanctioned bounded homes
        for cs in fi.calls:
            if F.INGESTS not in F.classify_call(cs):
                continue
            if _red015_covered(mi.rel):
                continue
            out.setdefault(mi.rel, []).append(RawFinding(
                "RED020", cs.line,
                "host->device copy reachable from an entry point "
                f"({' -> '.join(frames)}) with no staging node on the "
                "path — a one-shot copy is unbounded and synchronous; "
                "route the payload through utils.staging / "
                "ops/stream.py, or waive with the reason: device to "
                "device, or the payload's size bound"))
    return out


def run_flow_rules(project: Project,
                   summaries: Optional[Dict[str, Summary]] = None
                   ) -> Dict[str, List[RawFinding]]:
    """All four interprocedural rules over a seeded, linked project;
    findings keyed by reporting path. Pass `summaries` to reuse one
    compute_summaries fixpoint across the flow and conc passes."""
    if summaries is None:
        summaries = compute_summaries(project)
    merged: Dict[str, List[RawFinding]] = {}
    for part in (_red017(project, summaries), _red018(project, summaries),
                 _red019(project, summaries), _red020(project, summaries)):
        for rel, lst in part.items():
            merged.setdefault(rel, []).extend(lst)
    return merged


# ---------------------------------------------------------------- cache


def _source_hash(source: str) -> str:
    return hashlib.sha256(source.encode("utf-8", "replace")).hexdigest()


_FINGERPRINT: Optional[str] = None


def fingerprint_of(root: Path) -> str:
    """Content hash of every .py under `root`, by relative path."""
    h = hashlib.sha256()
    for f in sorted(Path(root).rglob("*.py")):
        h.update(f.relative_to(root).as_posix().encode())
        h.update(b"\0")
        try:
            h.update(f.read_bytes())
        except OSError:
            pass
    return h.hexdigest()[:16]


def schema_fingerprint() -> str:
    """fingerprint_of the port lint's own sources (memoized per
    process; the files under tpu_reductions_torch/lint/, never the JAX
    lint's). Part of the cache version stamp: a lint upgrade — even one
    that forgot to bump a schema constant — busts the fact cache,
    because stale facts from an older analyzer are worse than a cold
    re-extraction."""
    global _FINGERPRINT
    if _FINGERPRINT is None:
        import tpu_reductions_torch.lint as _pkg
        _FINGERPRINT = fingerprint_of(Path(_pkg.__file__).resolve().parent)
    return _FINGERPRINT


def _cache_version() -> list:
    return [CACHE_SCHEMA, F.FACTS_SCHEMA_VERSION,
            C.CONC_SCHEMA_VERSION, schema_fingerprint()]


def _load_cache(cache_path: Optional[Path]) -> dict:
    if cache_path is None:
        return {}
    try:
        data = json.loads(Path(cache_path).read_text())
    except (OSError, ValueError):
        return {}
    if data.get("version") != _cache_version():
        return {}
    files = data.get("files")
    return files if isinstance(files, dict) else {}


def _store_cache(cache_path: Optional[Path], entries: dict) -> None:
    if cache_path is None:
        return
    from tpu_reductions_torch.utils.jsonio import atomic_text_dump
    try:
        # json.dumps runs the C encoder; json.dump's streaming is several
        # times slower on a payload this size
        atomic_text_dump(cache_path, json.dumps({
            "version": _cache_version(), "files": entries}) + "\n")
    except OSError:
        pass                              # read-only tree: cache is best-effort


def build_cached_project(files: Sequence[Path], roots: Sequence[Path],
                         rels: Optional[Dict[Path, str]] = None,
                         cache_path: Optional[Path] = None) -> Project:
    """Extract every .py file into a linked Project, reusing cached
    per-file extractions whose content hash matches (the warm-run path
    the tier-1 gate budget depends on)."""
    cached = _load_cache(cache_path)
    entries: dict = {}
    modules: Dict[str, ModuleInfo] = {}
    conc: Dict[str, C.ConcInfo] = {}
    for f in files:
        if f.suffix != ".py":
            continue
        key = str(f.resolve())
        rel = (rels or {}).get(f, str(f)).replace("\\", "/")
        try:
            src = f.read_text()
        except (OSError, UnicodeDecodeError):
            continue
        sha = _source_hash(src)
        mod = module_name_for(f, roots)
        is_pkg = f.name == "__init__.py"
        hit = cached.get(key)
        if hit and hit.get("sha") == sha and hit.get("module") == mod \
                and hit.get("rel") == rel and "conc" in hit:
            mi = ModuleInfo.from_dict(hit["info"])
            ci = C.ConcInfo.from_dict(hit["conc"])
        else:
            mi = extract_module(src, mod, rel, is_pkg=is_pkg)
            F.seed_module(mi)
            ci = C.extract_conc(src, mod, rel, is_pkg=is_pkg)
        entries[key] = {"sha": sha, "module": mod, "rel": rel,
                        "info": mi.to_dict(), "conc": ci.to_dict()}
        modules[mod] = mi
        conc[mod] = ci
    if entries != cached:                 # a warm pass rewrites nothing
        _store_cache(cache_path, entries)
    project = Project(modules)
    project.conc = conc
    return project


def analyze_flow(files: Sequence[Path], roots: Sequence[Path],
                 rels: Optional[Dict[Path, str]] = None,
                 cache_path: Optional[Path] = None
                 ) -> Dict[str, List[RawFinding]]:
    """The engine's flow entry: extract (cached), link, propagate, and
    return RED017-RED024 raw findings keyed by reporting path (the
    device-flow rules and the concurrency rules share one
    compute_summaries fixpoint)."""
    project = build_cached_project(files, roots, rels=rels,
                                   cache_path=cache_path)
    summaries = compute_summaries(project)
    merged = run_flow_rules(project, summaries=summaries)
    conc_raw = C_analysis.run_conc_rules(project, project.conc,
                                         summaries=summaries)
    for rel, lst in conc_raw.items():
        merged.setdefault(rel, []).extend(lst)
    return merged


# ---------------------------------------------------------------- graph export


def export_graph(project: Project, fmt: str = "json") -> str:
    """The seam inventory: every function node with its facts and
    resolved edges (unresolved call sites included, marked as such),
    the locks, the thread roots and the spawn edges."""
    summaries = compute_summaries(project)
    conc = getattr(project, "conc", {})
    locks = sorted({lk for ci in conc.values() for lk in ci.locks})
    spawn_edges = []
    for module in sorted(conc):
        for qual in sorted(conc[module].functions):
            for sp in conc[module].functions[qual].spawns:
                callee = project.resolve_target(sp["target"]) \
                    if sp["target"] else None
                spawn_edges.append({
                    "from": f"{module}::{qual}", "to": callee,
                    "kind": sp["kind"], "line": sp["line"],
                    "daemon": sp["daemon"]})
    thread_roots = sorted({e["to"] for e in spawn_edges if e["to"]})
    if fmt == "json":
        nodes = []
        for fqn in sorted(project.nodes):
            mi, fi = project.nodes[fqn]
            s = summaries[fqn]
            nodes.append({
                "id": fqn, "module": mi.module, "qualname": fi.qualname,
                "path": mi.rel, "line": fi.line,
                "facts": {k: v for k, v in sorted(fi.facts.items())},
                "device_reach": s.device_reach,
                "gated": s.ungated_device is None,
                "guarded": s.unguarded_dispatch is None,
                "calls": [c.to_dict() for c in fi.calls],
            })
        edges = []
        unresolved = 0
        for fqn in sorted(project.nodes):
            for cs in project.nodes[fqn][1].calls:
                callee = project.resolve_target(cs.target) \
                    if cs.target else None
                if callee:
                    edges.append({"from": fqn, "to": callee,
                                  "line": cs.line})
                elif not cs.raw:
                    unresolved += 1
        return json.dumps({"modules": len(project.modules),
                           "functions": nodes, "edges": edges,
                           "dynamic_unresolved_calls": unresolved,
                           "locks": locks,
                           "thread_roots": thread_roots,
                           "spawn_edges": spawn_edges},
                          indent=1)
    if fmt == "dot":
        lines = ["digraph redlint_flow {", "  rankdir=LR;",
                 "  node [shape=box, fontsize=9];"]
        root_set = set(thread_roots)
        for fqn in sorted(project.nodes):
            mi, fi = project.nodes[fqn]
            facts = ",".join(sorted(fi.facts)) or "-"
            color = "red" if F.TOUCHES_DEVICE in fi.facts else (
                "green" if F.GATES in fi.facts else "black")
            shape = ', peripheries=2' if fqn in root_set else ''
            lines.append(
                f'  "{fqn}" [label="{mi.module}.{fi.qualname}\\n'
                f'[{facts}]", color={color}{shape}];')
        for lk in locks:
            lines.append(f'  "{lk}" [label="{lk}", shape=ellipse, '
                         'color=blue, fontsize=9];')
        seen = set()
        for fqn in sorted(project.nodes):
            for cs in project.nodes[fqn][1].calls:
                callee = project.resolve_target(cs.target) \
                    if cs.target else None
                if callee and (fqn, callee) not in seen:
                    seen.add((fqn, callee))
                    lines.append(f'  "{fqn}" -> "{callee}";')
        for e in spawn_edges:
            if e["to"] and (e["from"], e["to"], "spawn") not in seen:
                seen.add((e["from"], e["to"], "spawn"))
                lines.append(f'  "{e["from"]}" -> "{e["to"]}" '
                             '[style=dashed, color=blue, '
                             f'label="{e["kind"]}"];')
        lines.append("}")
        return "\n".join(lines)
    raise ValueError(f"unknown graph format: {fmt!r}")
