"""The port lint's mechanical fixers (--fix-docstrings,
--fix-stale-waivers), the counterpart of tpu_reductions/lint/fixers.py.

RED006 demands every public ops/bench docstring either cite the JAX or
reference file:line it re-creates or explicitly declare 'no reference
analog'. A citation cannot be invented mechanically, but
the declaration can be applied mechanically — it converts an *implicit*
omission into an *explicit, greppable* claim that can be challenged.
Only existing docstrings are amended; a missing docstring stays a
finding (writing one is authorship, not formatting).

RED009's fix IS mechanical: a stale waiver suppresses nothing, so
deleting it cannot change what the linter reports except to drop the
RED009 row itself. `fix_stale_waivers` removes standalone waiver lines
whole and strips trailing waivers back to the code, idempotently.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import List, Sequence, Tuple

from tpu_reductions_torch.lint.engine import (RULE_STALE_WAIVER, WAIVER_RE,
                                              iter_lintable, lint_paths)
from tpu_reductions_torch.lint.rules import (_CITATION_RE, _NO_ANALOG_RE,
                                             _in_citation_dirs)

MARKER = "No reference analog (port-native)."


def _docstring_nodes(tree: ast.Module):
    """(owner_name, docstring Constant node) for the module and every
    public def/class/method — mirrors the RED006 walk."""
    out = []

    def doc_const(node):
        body = node.body
        if body and isinstance(body[0], ast.Expr) and \
                isinstance(body[0].value, ast.Constant) and \
                isinstance(body[0].value.value, str):
            return body[0].value
        return None

    c = doc_const(tree)
    if c is not None:
        out.append(("<module>", c))
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and \
                not node.name.startswith("_"):
            c = doc_const(node)
            if c is not None:
                out.append((node.name, c))
            if isinstance(node, ast.ClassDef):
                for m in node.body:
                    if isinstance(m, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)) and \
                            not m.name.startswith("_"):
                        c = doc_const(m)
                        if c is not None:
                            out.append((f"{node.name}.{m.name}", c))
    return out


def fix_docstrings(paths: Sequence[str | Path]
                   ) -> List[Tuple[str, int, str]]:
    """Append the no-analog marker to every citation-less public
    docstring under `paths` (ops/bench files only). Returns
    [(path, line, owner_name)] for the amended docstrings."""
    fixed: List[Tuple[str, int, str]] = []
    for f in iter_lintable(paths):
        rel = str(f).replace("\\", "/")
        if f.suffix != ".py" or not _in_citation_dirs(rel):
            continue
        source = f.read_text()
        try:
            tree = ast.parse(source)
        except SyntaxError:
            continue
        lines = source.splitlines(keepends=True)
        # amend bottom-up so earlier insertions don't shift line numbers
        targets = []
        for name, node in _docstring_nodes(tree):
            doc = node.value
            if _CITATION_RE.search(doc) or _NO_ANALOG_RE.search(doc):
                continue
            targets.append((name, node))
        for name, node in sorted(targets, key=lambda t: -t[1].end_lineno):
            end = node.end_lineno - 1          # 0-based closing line
            closing = lines[end]
            for quote in ('"""', "'''", '"', "'"):
                idx = closing.rfind(quote)
                if idx != -1:
                    break
            if idx == -1:
                continue
            indent = " " * node.col_offset
            if node.lineno == node.end_lineno:
                # one-liner: """Text.""" -> """Text. <marker>"""
                lines[end] = (closing[:idx].rstrip() + " " + MARKER
                              + closing[idx:])
            else:
                lines[end] = (closing[:idx].rstrip() + "\n\n" + indent
                              + MARKER + "\n" + indent + closing[idx:])
            fixed.append((str(f), node.lineno, name))
        if targets:
            f.write_text("".join(lines))
    return fixed


_TRAILING_WAIVER_RE = re.compile(r"\s*#\s*redlint:\s*disable=.*$")


def fix_stale_waivers(paths: Sequence[str | Path], *, flow: bool = True,
                      flow_cache: str | Path | None = None
                      ) -> List[Tuple[str, int, str]]:
    """Delete every waiver comment RED009 reports as stale under
    `paths`: a waiver alone on its line is removed whole; a trailing
    waiver is stripped back to the code it decorated. Idempotent — a
    second run finds nothing stale. Returns [(path, line, rules)] for
    the removed waivers."""
    stale: dict = {}
    for f in lint_paths(paths, flow=flow, flow_cache=flow_cache):
        if f.rule == RULE_STALE_WAIVER:
            stale.setdefault(f.path, []).append(f.line)
    removed: List[Tuple[str, int, str]] = []
    for path, line_nos in stale.items():
        p = Path(path)
        lines = p.read_text().splitlines(keepends=True)
        # bottom-up so whole-line deletions don't shift pending targets
        for ln in sorted(set(line_nos), reverse=True):
            raw = lines[ln - 1]
            m = WAIVER_RE.search(raw)
            rules = m.group("rules").strip() if m else "?"
            if raw.strip().startswith("#"):
                del lines[ln - 1]
            else:
                nl = "\n" if raw.endswith("\n") else ""
                lines[ln - 1] = _TRAILING_WAIVER_RE.sub(
                    "", raw.rstrip("\n")).rstrip() + nl
            removed.append((path, ln, rules))
        p.write_text("".join(lines))
    return removed
