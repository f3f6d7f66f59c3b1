"""The port lint's engine: file walking, waivers, finding assembly (the
counterpart of tpu_reductions/lint/engine.py, same signatures).

Waiver syntax (one escape hatch per line, never per file):

    x.to(device)  # redlint: disable=RED015 -- 4 KiB index table

* the comment may sit on the flagged line, or alone on the line above;
* `disable=` takes a comma-separated rule list;
* the ` -- reason` is MANDATORY: a waiver without a reason is itself a
  finding (RED000), and a waiver that suppresses nothing is reported as
  stale (RED009) so dead waivers can't rot in the tree.
"""

from __future__ import annotations

import io
import re
import tokenize
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

from tpu_reductions_torch.lint.rules import RawFinding, check_python

WAIVER_RE = re.compile(
    r"#\s*redlint:\s*disable=(?P<rules>[A-Z0-9, ]+?)"
    r"(?:\s*--\s*(?P<reason>.*\S))?\s*$")

# the engine's own rules: not waivable themselves
RULE_MALFORMED_WAIVER = "RED000"
RULE_STALE_WAIVER = "RED009"

# the interprocedural rules computed by lint/flow/ + lint/conc/.
# Owned here (not in flow/) so the waiver machinery can
# reason about them without importing the flow package: a waiver naming
# one of these is only judged stale when the whole-program analysis
# actually ran.
FLOW_RULES = ("RED017", "RED018", "RED019", "RED020",
              "RED021", "RED022", "RED023", "RED024")

_SKIP_DIRS = {".git", "__pycache__", "_build", "node_modules", ".venv"}


@dataclass(frozen=True)
class Finding:
    """One violation: the machine-readable report row the acceptance
    contract fixes as {rule, path, line, message}."""
    rule: str
    path: str
    line: int
    message: str

    def to_dict(self) -> dict:
        return asdict(self)

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


@dataclass
class _Waiver:
    line: int            # line the waiver comment sits on
    rules: Tuple[str, ...]
    reason: str | None
    applies_to: Tuple[int, ...]  # source lines it can suppress
    used: bool = False


def _comment_lines(source: str, is_python: bool) -> List[Tuple[int, str,
                                                               bool]]:
    """(line, comment_text, is_standalone) for every real comment.
    Python files go through tokenize so waiver EXAMPLES inside
    docstrings/strings (this module's own docstring, error messages)
    are never parsed as live waivers; a file tokenize refuses falls
    back to a line scan."""
    out: List[Tuple[int, str, bool]] = []
    if is_python:
        try:
            for tok in tokenize.generate_tokens(
                    io.StringIO(source).readline):
                if tok.type == tokenize.COMMENT:
                    standalone = tok.line.strip().startswith("#")
                    out.append((tok.start[0], tok.string, standalone))
            return out
        except (tokenize.TokenError, IndentationError, SyntaxError):
            # unparseable: degrade to the line scan —
            # dropping any tokens banked before the error so the two
            # passes never double-report one comment
            out = []
    for i, raw in enumerate(source.splitlines(), start=1):
        idx = _hash_outside_quotes(raw)
        if idx != -1:
            out.append((i, raw[idx:], raw.strip().startswith("#")))
    return out


def _hash_outside_quotes(raw: str) -> int:
    """Index of the first ``#`` not inside a quoted string, -1 if none.
    The degraded line scan must not read `url = "http://x#frag"` as a
    comment and then treat waiver-shaped string contents as live
    waivers (single-line quoting only — good enough for a fallback)."""
    quote = None
    i = 0
    while i < len(raw):
        c = raw[i]
        if quote is not None:
            if c == "\\":
                i += 2
                continue
            if c == quote:
                quote = None
        elif c in "\"'":
            quote = c
        elif c == "#":
            return i
        i += 1
    return -1


def _parse_waivers(source: str, is_python: bool) -> List[_Waiver]:
    out = []
    lines = source.splitlines()
    for i, comment, standalone in _comment_lines(source, is_python):
        m = WAIVER_RE.search(comment)
        if not m:
            continue
        rules = tuple(r.strip() for r in m.group("rules").split(",")
                      if r.strip())
        # a standalone waiver comment guards the NEXT line; an inline
        # one guards its own line. A standalone waiver above a decorated
        # `def` reaches past the decorator lines to the `def` itself —
        # AST rules anchor findings at the def line, not the decorator.
        if standalone:
            applies = [i, i + 1]
            j = i + 1
            while is_python and j <= len(lines) and \
                    lines[j - 1].lstrip().startswith("@"):
                j += 1
                applies.append(j)
            applies = tuple(applies)
        else:
            applies = (i,)
        out.append(_Waiver(i, rules, m.group("reason"), applies))
    return out


def _apply_waivers(raw: Iterable[RawFinding], waivers: List[_Waiver],
                   path: str, flow_active: bool = False,
                   per_file_active: bool = True) -> List[Finding]:
    findings: List[Finding] = []
    for f in raw:
        suppressed = False
        for w in waivers:
            if w.reason and f.rule in w.rules and f.line in w.applies_to:
                w.used = True
                suppressed = True
                break
        if not suppressed:
            findings.append(Finding(f.rule, path, f.line, f.message))
    flow_set = set(FLOW_RULES)
    for w in waivers:
        if not w.reason:
            findings.append(Finding(
                RULE_MALFORMED_WAIVER, path, w.line,
                "waiver without a reason — write "
                "'# redlint: disable=RED00X -- why this is safe'"))
        elif not w.used:
            rset = set(w.rules)
            if not flow_active and rset & flow_set:
                # RED017-RED024 need the whole-program pass; a
                # single-file lint can't judge their waivers stale
                continue
            if not per_file_active and rset - flow_set:
                # symmetric: under --changed-only the per-file rules
                # were skipped for this file, so their waivers can't
                # be judged stale either
                continue
            findings.append(Finding(
                RULE_STALE_WAIVER, path, w.line,
                f"stale waiver ({','.join(w.rules)}): no matching finding "
                "on this line — delete it or fix the rule id"))
    return findings


def lint_file(path: Path, rel: str | None = None, *,
              extra_raw: Sequence[RawFinding] = (),
              flow_active: bool = False,
              per_file: bool = True) -> List[Finding]:
    """Lint one .py file through the AST rules (any other suffix gives
    no finding).
    `rel` overrides the path string used for whitelist suffix matching
    and reporting (defaults to the path as given). `extra_raw` carries
    this file's findings from the whole-program flow pass (lint_paths)
    so they share the per-file waiver machinery; `flow_active` tells the
    staleness check whether RED017-RED024 waivers can be judged.
    `per_file=False` (the --changed-only path for unchanged files)
    skips the per-file AST rules but still applies this file's
    waivers to the whole-program findings in `extra_raw`."""
    rel = rel if rel is not None else str(path)
    rel_posix = rel.replace("\\", "/")
    try:
        source = path.read_text()
    except (OSError, UnicodeDecodeError) as e:
        return [Finding("RED???", rel, 1, f"unreadable: {e}")]
    if path.suffix != ".py":
        return []
    raw = (list(check_python(rel_posix, source)) if per_file else []) \
        + list(extra_raw)
    waivers = _parse_waivers(source, is_python=True)
    return sorted(_apply_waivers(raw, waivers, rel,
                                 flow_active=flow_active,
                                 per_file_active=per_file),
                  key=lambda f: (f.line, f.rule))


def iter_lintable(paths: Sequence[str | Path]) -> List[Path]:
    """Expand files/dirs into the .py set, skipping cache and build
    dirs. The JAX lint also reads .sh; the port has no shell scripts,
    so its shell rules (RED008, the shell half of RED013) are not here."""
    out: List[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            for f in sorted(p.rglob("*")):
                if f.suffix == ".py" and f.is_file() and \
                        not (_SKIP_DIRS & set(f.parts)):
                    out.append(f)
        elif p.is_file():
            out.append(p)
        else:
            raise FileNotFoundError(f"no such path: {p}")
    return out


def lint_paths(paths: Sequence[str | Path], *, flow: bool = True,
               flow_cache: str | Path | None = None,
               restrict: set | None = None) -> List[Finding]:
    """Lint every .py file under `paths`; the package's public
    entry point (CLI: python -m tpu_reductions_torch.lint). With `flow` on
    (the default), the whole-program device-flow + concurrency pass
    (lint/flow/, lint/conc/) runs over all the .py files together and
    its RED017-RED024 findings merge into the per-file waiver
    application; `flow_cache` names the content-hash fact cache
    (the CLI's default is .lint_cache_torch.json). `restrict` (the
    --changed-only mode) limits the per-file AST rules to the given
    resolved paths while the whole-program pass still covers
    everything."""
    files = iter_lintable(paths)
    flow_raw: Dict[str, List[RawFinding]] = {}
    if flow:
        py = [f for f in files if f.suffix == ".py"]
        if py:
            # deferred: flow imports lint.rules, which would re-enter
            # this package's __init__ during a top-level import here
            from tpu_reductions_torch.lint.flow.dataflow import analyze_flow
            roots = [Path(p) for p in paths]
            rels = {f: str(f).replace("\\", "/") for f in py}
            flow_raw = analyze_flow(
                py, roots, rels=rels,
                cache_path=Path(flow_cache) if flow_cache else None)
    findings: List[Finding] = []
    for f in files:
        extra = flow_raw.get(str(f).replace("\\", "/"), [])
        per_file = restrict is None or f.resolve() in restrict
        findings += lint_file(f, extra_raw=extra, flow_active=flow,
                              per_file=per_file)
    return sorted(findings, key=lambda x: (x.path, x.line, x.rule))


def summarize(findings: Sequence[Finding]) -> Dict[str, int]:
    """Per-rule finding counts for the text report footer."""
    counts: Dict[str, int] = {}
    for f in findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    return dict(sorted(counts.items()))
