"""Interprocedural concurrency rules RED021-RED024 of the port lint (the
counterpart of tpu_reductions/lint/conc/analysis.py).

The pass links the per-file conc facts (conc/extract.py) against the
flow layer's call graph (flow/callgraph.py) and runs one worklist
fixpoint from the discovered thread roots, computing per function:

* ``roots_of``  — which thread roots can be executing this function
  (every ``__main__`` guard collapses into one "<main thread>" root:
  alternative entry points never run concurrently in one process,
  unlike spawned threads);
* ``held_must`` — locks held on EVERY path into the function
  (intersection over call edges; the guarded-by inference RED021
  credits a write with);
* ``held_may``  — locks held on SOME path in (union, with a witness
  call site; what RED022/RED023 must assume).

Rules (docs/PORT.md, "The lint on the port"):

* RED021 — a shared attribute (``self.X`` / module global) written on
  paths reachable from >= 2 thread roots with no single lock common to
  every write (init writes — ``__init__``, module body, ``<main>`` —
  are excluded as happens-before publication);
* RED022 — a cycle in the nested-acquisition lock-order graph;
* RED023 — a blocking call (socket recv/accept, untimed result/get/
  join/wait/communicate, select, sleep) or a device sync
  (a card synchronize, via the flow layer's SYNC facts) while
  holding a lock — the static form of the exit-4 stall amplifier;
* RED024 — a non-daemon thread spawned on a reached path with no join
  anywhere on its owner's stop/drain surface.

Soundness posture matches the flow layer: resolved edges only (a
dynamic call is recorded, never propagated over), spawn targets count
as roots whether or not the ``.start()`` is visible, and functions the
root set never reaches are not judged.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Set, Tuple

from tpu_reductions_torch.lint.conc.extract import ConcInfo
from tpu_reductions_torch.lint.flow import facts as F
from tpu_reductions_torch.lint.flow.callgraph import (MAIN_GUARD, MODULE_BODY,
                                                      Project)
from tpu_reductions_torch.lint.rules import RawFinding

MAIN_ROOT = "<main thread>"


def _label(project: Project, fqn: str) -> str:
    mi, fi = project.nodes[fqn]
    return f"{mi.module}.{fi.qualname}"


class _ConcState:
    """The fixpoint result plus the lookup seams the rules share."""

    def __init__(self, project: Project,
                 conc: Dict[str, ConcInfo]) -> None:
        self.project = project
        self.conc = conc
        self.fn: Dict[str, Tuple[ConcInfo, object]] = {}
        for module, ci in conc.items():
            for qual, cfn in ci.functions.items():
                fqn = f"{module}::{qual}"
                if fqn in project.nodes:
                    self.fn[fqn] = (ci, cfn)
        self.lock_ids: Set[str] = set()
        for ci in conc.values():
            self.lock_ids.update(ci.locks)
        self.roots_of: Dict[str, Set[str]] = {}
        self.held_must: Dict[str, Set[str]] = {}
        self.held_may: Dict[str, Dict[str, Tuple[str, int]]] = {}
        self.via: Dict[str, Tuple[str, ...]] = {}
        self._propagate()

    def lexical(self, fqn: str, line: int) -> Set[str]:
        """Locks lexically held at `line` inside `fqn` (with-extents
        and acquire()/release() spans from the conc extraction)."""
        ent = self.fn.get(fqn)
        if ent is None:
            return set()
        return {a["lock"] for a in ent[1].acquires
                if a["lock"] in self.lock_ids
                and a["line"] <= line <= a["end"]}

    def _seed(self, fqn: str, label: str, work: deque) -> None:
        self.roots_of.setdefault(fqn, set()).add(label)
        self.held_must.setdefault(fqn, set())
        self.held_may.setdefault(fqn, {})
        self.via.setdefault(fqn, ())
        work.append(fqn)

    def thread_roots(self) -> List[Tuple[str, str]]:
        """(root fqn, spawn kind) for every resolved spawn target and
        socketserver handler in the tree."""
        out = []
        for module, ci in sorted(self.conc.items()):
            for qual in sorted(ci.functions):
                for sp in ci.functions[qual].spawns:
                    if not sp["target"]:
                        continue
                    callee = self.project.resolve_target(sp["target"])
                    if callee is not None:
                        out.append((callee, sp["kind"]))
            for qual in ci.handler_roots:
                fqn = f"{module}::{qual}"
                if fqn in self.project.nodes:
                    out.append((fqn, "handler"))
        return out

    def _propagate(self) -> None:
        project = self.project
        work: deque = deque()
        for fqn, _kind in self.thread_roots():
            self._seed(fqn, _label(project, fqn), work)
        for fqn in project.entries():
            self._seed(fqn, MAIN_ROOT, work)
        while work:
            f = work.popleft()
            mi, fi = project.nodes[f]
            for cs in fi.calls:
                callee = project.resolve_target(cs.target) \
                    if cs.target else None
                if callee is None or callee == f:
                    continue
                lex = self.lexical(f, cs.line)
                edge_must = self.held_must.get(f, set()) | lex
                changed = False
                rts = self.roots_of.setdefault(callee, set())
                new_roots = self.roots_of.get(f, set()) - rts
                if new_roots:
                    rts.update(new_roots)
                    changed = True
                if callee not in self.held_must:
                    self.held_must[callee] = set(edge_must)
                    changed = True
                else:
                    inter = self.held_must[callee] & edge_must
                    if inter != self.held_must[callee]:
                        self.held_must[callee] = inter
                        changed = True
                hm = self.held_may.setdefault(callee, {})
                for lock in self.held_may.get(f, {}):
                    if lock not in hm:
                        hm[lock] = self.held_may[f][lock]
                        changed = True
                for lock in lex:
                    if lock not in hm:
                        hm[lock] = (mi.rel, cs.line)
                        changed = True
                if callee not in self.via:
                    self.via[callee] = self.via.get(f, ()) \
                        + (_label(project, f),)
                    changed = True
                if changed:
                    work.append(callee)


def _fmt_locks(locks: Set[str]) -> str:
    return ", ".join(sorted(locks)) if locks else "no lock"


def _via_text(st: _ConcState, fqn: str) -> str:
    frames = st.via.get(fqn, ())
    if not frames:
        return ""
    return f" (entered via {' -> '.join(frames)})"


def _red021(st: _ConcState) -> Dict[str, List[RawFinding]]:
    project = st.project
    by_attr: Dict[str, List[Tuple[str, int, Set[str]]]] = {}
    for fqn in sorted(st.roots_of):
        ent = st.fn.get(fqn)
        if ent is None:
            continue
        qual = project.nodes[fqn][1].qualname
        if qual in (MODULE_BODY, MAIN_GUARD) or \
                qual.split(".")[-1] == "__init__":
            continue                      # happens-before publication
        for w in ent[1].writes:
            if w["attr"] in st.lock_ids:
                continue
            guards = (st.held_must.get(fqn, set())
                      | st.lexical(fqn, w["line"])) & st.lock_ids
            by_attr.setdefault(w["attr"], []).append(
                (fqn, w["line"], guards))
    out: Dict[str, List[RawFinding]] = {}
    for attr in sorted(by_attr):
        ws = by_attr[attr]
        roots: Set[str] = set()
        for fqn, _, _ in ws:
            roots |= st.roots_of[fqn]
        if len(roots) < 2:
            continue
        common = set.intersection(*(g for _, _, g in ws))
        if common:
            continue
        fqn, line, guards = min(ws, key=lambda t: (len(t[2]), t[1]))
        mi = project.nodes[fqn][0]
        names = ", ".join(sorted(roots))
        out.setdefault(mi.rel, []).append(RawFinding(
            "RED021", line,
            f"shared attribute `{attr}` is written on paths reachable "
            f"from {len(roots)} thread roots ({names}) with no common "
            f"lock guarding every write — this write holds "
            f"{_fmt_locks(guards)}{_via_text(st, fqn)}; serialize all "
            "writes to it under one lock, or waive naming the "
            "invariant that already serializes them"))
    return out


def _scc(graph: Dict[str, Set[str]]) -> List[List[str]]:
    """Tarjan SCCs (iterative; graphs here are a handful of locks)."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on: Set[str] = set()
    stack: List[str] = []
    out: List[List[str]] = []
    counter = [0]

    def strongconnect(v: str) -> None:
        work = [(v, iter(sorted(graph.get(v, ()))))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on.add(w)
                    work.append((w, iter(sorted(graph.get(w, ())))))
                    advanced = True
                    break
                if w in on:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                out.append(comp)

    for v in sorted(graph):
        if v not in index:
            strongconnect(v)
    return out


def _red022(st: _ConcState) -> Dict[str, List[RawFinding]]:
    project = st.project
    edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
    for fqn in sorted(st.roots_of):
        ent = st.fn.get(fqn)
        if ent is None:
            continue
        rel = project.nodes[fqn][0].rel
        acquires = [a for a in ent[1].acquires
                    if a["lock"] in st.lock_ids]
        entry_held = set(st.held_may.get(fqn, {})) & st.lock_ids
        for a in acquires:
            held = set(entry_held)
            held |= {x["lock"] for x in acquires
                     if x is not a and x["line"] <= a["line"] <= x["end"]
                     and x["line"] < a["line"]}
            for h in held:
                if h != a["lock"]:
                    edges.setdefault((h, a["lock"]), (rel, a["line"]))
    graph: Dict[str, Set[str]] = {}
    for (h, lk) in edges:
        graph.setdefault(h, set()).add(lk)
        graph.setdefault(lk, set())
    out: Dict[str, List[RawFinding]] = {}
    for comp in _scc(graph):
        if len(comp) < 2:
            continue
        comp_set = set(comp)
        witnesses = sorted(
            f"`{b}` acquired while holding `{a}` at {rel}:{line}"
            for (a, b), (rel, line) in edges.items()
            if a in comp_set and b in comp_set)
        rel, line = min(
            (edges[e] for e in edges
             if e[0] in comp_set and e[1] in comp_set),
            key=lambda t: (t[0], t[1]))
        out.setdefault(rel, []).append(RawFinding(
            "RED022",
            line,
            "lock-order inversion among {" + ", ".join(sorted(comp))
            + "}: " + "; ".join(witnesses)
            + " — two threads taking these in opposite order deadlock "
              "and the watchdog cannot attribute it; pick one "
              "global acquisition order"))
    return out


def _red023(st: _ConcState, summaries) -> Dict[str, List[RawFinding]]:
    project = st.project
    out: Dict[str, List[RawFinding]] = {}
    for fqn in sorted(st.roots_of):
        mi, fi = project.nodes[fqn]
        ent = st.fn.get(fqn)
        entry_held = set(st.held_may.get(fqn, {})) & st.lock_ids
        if ent is not None:
            for b in ent[1].blocking:
                held = (entry_held | st.lexical(fqn, b["line"])) \
                    & st.lock_ids
                if b["what"] == "wait" and b["chain"] in held:
                    held = held - {b["chain"]}   # Condition.wait releases
                if not held:
                    continue
                out.setdefault(mi.rel, []).append(RawFinding(
                    "RED023", b["line"],
                    f"blocking {b['what']}() call (`{b['raw']}`) while "
                    f"holding {_fmt_locks(held)}"
                    f"{_via_text(st, fqn)} — a stall here parks every "
                    "waiter on the lock (the static exit-4 amplifier); "
                    "move the call outside the critical section or "
                    "bound it with a timeout"))
        if summaries is None:
            continue
        for cs in fi.calls:
            held = (entry_held | st.lexical(fqn, cs.line)) & st.lock_ids
            if not held:
                continue
            cfacts = F.classify_call(cs)
            callee = project.resolve_target(cs.target) if cs.target \
                else None
            syncs = F.SYNC in cfacts or (
                callee is not None and callee in summaries
                and summaries[callee].sync_reach)
            if not syncs:
                continue
            what = "device sync (synchronize)" if F.SYNC in cfacts \
                else (f"call to {_label(project, callee)} that reaches "
                      "a card synchronize")
            out.setdefault(mi.rel, []).append(RawFinding(
                "RED023", cs.line,
                f"{what} while holding {_fmt_locks(held)}"
                f"{_via_text(st, fqn)} — a card stall inside the "
                "critical section parks every waiter on the lock "
                "(the static exit-4 amplifier); hoist the device sync "
                "outside the lock"))
            break                          # one sync finding per function
    return out


def _joined(st: _ConcState, module: str, cls: Optional[str],
            cfn, assigned: str) -> bool:
    if not assigned:
        return False
    if assigned.startswith("self."):
        ci = st.conc.get(module)
        if ci is None or cls is None:
            return False
        return any(q.split(".")[0] == cls and assigned in f2.joins
                   for q, f2 in ci.functions.items())
    return assigned in cfn.joins


def _red024(st: _ConcState) -> Dict[str, List[RawFinding]]:
    project = st.project
    out: Dict[str, List[RawFinding]] = {}
    for fqn in sorted(st.roots_of):
        ent = st.fn.get(fqn)
        if ent is None:
            continue
        mi, fi = project.nodes[fqn]
        cls = fi.qualname.split(".")[0] if "." in fi.qualname else None
        for sp in ent[1].spawns:
            if sp["kind"] == "submit" or sp["daemon"] is True:
                continue
            if _joined(st, mi.module, cls, ent[1], sp["assigned"]):
                continue
            tgt = sp["raw"] or sp["target"] or "<dynamic>"
            out.setdefault(mi.rel, []).append(RawFinding(
                "RED024", sp["line"],
                f"non-daemon {sp['kind']} (target `{tgt}`) spawned "
                "with no join on any stop/drain path — a leaked "
                "worker outlives stop() and keeps the process (and "
                "the card context it holds) alive past exit; pass "
                "daemon=True or join it on every stop path"))
    return out


def run_conc_rules(project: Project, conc: Dict[str, ConcInfo],
                   summaries=None) -> Dict[str, List[RawFinding]]:
    """All four concurrency rules over a linked project + its per-file
    conc facts; findings keyed by reporting path. `summaries` is the
    flow layer's fixpoint output (dataflow.compute_summaries), shared
    so the device-sync half of RED023 sees SYNC reachability without a
    second propagation."""
    if not conc:
        return {}
    st = _ConcState(project, conc)
    merged: Dict[str, List[RawFinding]] = {}
    for part in (_red021(st), _red022(st), _red023(st, summaries),
                 _red024(st)):
        for rel, lst in part.items():
            merged.setdefault(rel, []).extend(lst)
    return merged
