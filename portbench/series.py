"""Run one cell several times, one seed a run, each in a process of its
own, and summarise the runs: what a bound and a limit are set from.

  python3 -m portbench.series --workload <cell> --seeds 1,2,3 \
      --seconds 10 [--trace 1] --out runs.jsonl

Each run's last line, exit code, wall seconds and the end of its standard
error go to `--out`, one JSON object a line; then each metric's median
and spread (the quartiles' distance over the median) and each compared
number's widest reading are printed. The benchmark's own runs never use
this.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

from portbench import yardstick

RUN_TIMEOUT_S = 420


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"


def run_one(workload: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, "-m", "portbench", "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(trace)]
    t0 = time.perf_counter()
    try:
        p = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=RUN_TIMEOUT_S)
        rc, stdout, stderr = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as exc:
        rc, stdout, stderr = 124, exc.stdout or "", exc.stderr or ""
        stdout = stdout.decode() if isinstance(stdout, bytes) else stdout
        stderr = stderr.decode() if isinstance(stderr, bytes) else stderr
    wall = time.perf_counter() - t0
    last = stdout.strip().splitlines()[-1] if stdout.strip() else ""
    try:
        line = json.loads(last)
    except json.JSONDecodeError:
        line = None
    return {"workload": workload, "seed": seed, "trace": trace, "rc": rc,
            "wall_s": wall, "line": line, "stdout_head": stdout[:2000],
            "stderr_tail": stderr[-3000:]}


def summary(runs: list) -> list:
    """Per metric: n, median and spread; per compared number: the widest
    reading."""
    values: dict = {}
    checks: dict = {}
    for r in runs:
        if not r["line"]:
            continue
        for k, m in r["line"]["metrics"].items():
            values.setdefault(k, []).append(m["value"])
        for k, c in r["line"].get("checks", {}).items():
            checks[k] = max(checks.get(k, c["value"]), c["value"])
    out = []
    for k, v in sorted(values.items()):
        sp = yardstick.spread(v) if len(v) >= 2 else float("nan")
        out.append(f"{k}: n={len(v)} median={statistics.median(v)!r} "
                   f"spread={sp!r} min={min(v)!r} max={max(v)!r}")
    for k, v in sorted(checks.items()):
        out.append(f"check {k}: widest {v!r}")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.series")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    print(f"card: {card()}", flush=True)
    runs = []
    with open(args.out, "a") as f:
        for seed in (int(s) for s in args.seeds.split(",")):
            r = run_one(args.workload, seed, args.seconds, args.trace)
            runs.append(r)
            f.write(json.dumps(r) + "\n")
            f.flush()
            ln = r["line"] or {}
            metrics = {k: m["value"] for k, m in ln.get("metrics", {}).items()}
            checks = {k: c["value"] for k, c in ln.get("checks", {}).items()}
            print(f"seed {seed} trace {args.trace} rc {r['rc']} "
                  f"wall {r['wall_s']:.1f} s correct {ln.get('correct')} "
                  f"metrics {metrics} checks {checks}", flush=True)
            if r["rc"] != 0:
                print(r["stderr_tail"][-1500:], flush=True)
    for text in summary(runs):
        print(text, flush=True)
    return 0 if all(r["rc"] == 0 for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
