"""The port lint's CLI (the counterpart of tpu_reductions/lint/__main__.py,
every option kept).

    python -m tpu_reductions_torch.lint [paths...] [--format=text|json]
                                  [--no-flow] [--flow-cache=FILE]
                                  [--graph=dot|json] [--changed-only]
                                  [--fix-docstrings] [--fix-stale-waivers]

Exit codes: 0 clean, 1 findings, 2 usage error (argparse). JSON output
is a list of {rule, path, line, message} objects — one per violation,
sorted by (path, line, rule) — for machine consumption (CI annotations,
the test gate). The whole-program device-flow + concurrency pass
(RED017-RED024, lint/flow/ + lint/conc/) runs by default with a
content-hash fact cache at .lint_cache_torch.json (not the JAX lint's
.lint_cache.json: each linter's version stamp rejects the other's
entries wholesale, so a shared file would always run cold); --graph
prints the resolved call graph + facts (thread-root/lock nodes
included) instead of linting. --changed-only restricts the per-file
rules to `git diff`-touched files for fast pre-commit iteration while
the whole-program pass still covers the full tree. The default paths
are the port's package and chip_smoke.py. The lint imports neither
torch nor jax, so it runs on a machine that has either or neither.
"""

from __future__ import annotations

import argparse
import json
import sys

from tpu_reductions_torch.lint.engine import lint_paths, summarize
from tpu_reductions_torch.lint.fixers import fix_docstrings, fix_stale_waivers


def _print_graph(paths, fmt: str, cache: str | None) -> int:
    from pathlib import Path

    from tpu_reductions_torch.lint.engine import iter_lintable
    from tpu_reductions_torch.lint.flow.dataflow import (build_cached_project,
                                                   export_graph)
    py = [f for f in iter_lintable(paths) if f.suffix == ".py"]
    project = build_cached_project(
        py, [Path(p) for p in paths],
        rels={f: str(f).replace("\\", "/") for f in py},
        cache_path=Path(cache) if cache else None)
    print(export_graph(project, fmt))
    return 0


def _changed_files():
    """Resolved paths `git` reports as changed vs HEAD (tracked diffs
    plus untracked non-ignored files); None when git is unavailable or
    this is not a work tree (callers then lint everything)."""
    import subprocess
    from pathlib import Path
    names = []
    try:
        for cmd in (["git", "diff", "--name-only", "HEAD"],
                    ["git", "ls-files", "--others", "--exclude-standard"]):
            r = subprocess.run(cmd, capture_output=True, text=True,
                               check=True, timeout=30)
            names += [ln for ln in r.stdout.splitlines() if ln.strip()]
    except (OSError, subprocess.SubprocessError):
        return None
    return {Path(n).resolve() for n in names}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="tpu_reductions_torch.lint",
        description="the port lint: static checks of the port's rules "
                    "(docs/PORT.md, 'The lint on the port')")
    p.add_argument("paths", nargs="*", default=None,
                   help="files or directories to lint (default: the "
                        "tpu_reductions_torch package + chip_smoke.py)")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--no-flow", action="store_true",
                   help="skip the whole-program device-flow and "
                        "concurrency passes (RED017-RED024; lint/flow/ "
                        "+ lint/conc/)")
    p.add_argument("--changed-only", action="store_true",
                   help="run the per-file rules only on files git "
                        "reports as changed vs HEAD (tracked diffs + "
                        "untracked); the whole-program flow/conc pass "
                        "still covers the full tree")
    p.add_argument("--flow-cache", default=".lint_cache_torch.json",
                   metavar="FILE",
                   help="content-hash per-file fact cache for the flow "
                        "pass (default: %(default)s; empty string "
                        "disables caching)")
    p.add_argument("--graph", choices=("dot", "json"),
                   help="print the resolved call graph with per-function "
                        "facts instead of linting")
    p.add_argument("--fix-docstrings", action="store_true",
                   help="append an explicit 'No reference analog "
                        "(port-native).' marker to public ops/bench "
                        "docstrings that lack a citation (RED006), then "
                        "re-lint")
    p.add_argument("--fix-stale-waivers", action="store_true",
                   help="delete waiver comments RED009 reports as stale "
                        "(standalone waiver lines removed whole; trailing "
                        "waivers stripped to the code), then re-lint")
    ns = p.parse_args(argv)

    paths = ns.paths or ["tpu_reductions_torch", "chip_smoke.py"]
    flow = not ns.no_flow
    cache = ns.flow_cache or None
    restrict = _changed_files() if ns.changed_only else None
    try:
        if ns.graph:
            return _print_graph(paths, ns.graph, cache)
        if ns.fix_docstrings:
            fixed = fix_docstrings(paths)
            for path, line, name in fixed:
                print(f"fixed: {path}:{line}: marked '{name}' as "
                      "no-reference-analog", file=sys.stderr)
        if ns.fix_stale_waivers:
            removed = fix_stale_waivers(paths, flow=flow,
                                        flow_cache=cache)
            for path, line, rules in removed:
                print(f"fixed: {path}:{line}: removed stale waiver "
                      f"({rules})", file=sys.stderr)
        findings = lint_paths(paths, flow=flow, flow_cache=cache,
                              restrict=restrict)
    except FileNotFoundError as e:
        p.error(str(e))

    if ns.format == "json":
        print(json.dumps([f.to_dict() for f in findings], indent=2))
    else:
        for f in findings:
            print(f.render())
        if findings:
            counts = ", ".join(f"{r}: {n}"
                               for r, n in summarize(findings).items())
            print(f"redlint: {len(findings)} finding(s) ({counts})")
        else:
            print("redlint: clean")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
