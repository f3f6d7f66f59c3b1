"""The flagship experiment on the card: the grid, the curves, the report.

The counterpart of the Python in scripts/run_tpu_experiment.sh (its steps
2-6), as a module, since the port adds nothing under scripts/:

1. the flagship grid (sweep.FLAGSHIP_GRID: float64 and int32 x SUM/MIN/MAX
   at n = 2^24, 3 repeats, kernel 6, chained) through sweep_all into
   OUT/single_chip/raw_output, and its averages (regen.collect_averages)
   into OUT/single_chip/averages.json;
2. the bandwidth-vs-N curves, chained SUM through kernel 6 from 2^10:
   bfloat16 to 2^30, float64 to 2^28, int32 to 2^29, then the int32 2^30
   cell (4 GiB) last and alone. Each verified cell is merged into
   OUT/shmoo.json as it lands, and a cell that file already holds as a
   verified row of the same discipline is not measured again. A
   directory whose OUT/device.txt names another device is refused;
3. the figure (OUT/bandwidth_vs_n.*), the roofline annotation
   (OUT/roofline.json, bench/roofline.py), report.md and report.tex
   (bench/report.py) and writeup.pdf (bench/pdf.py; without matplotlib a
   skip note).

The report's device line is the card's name and power limit as
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
them, kept in OUT/device.txt for bench/regen.py. The JAX script's step 1,
the timing calibration, is its own CLI here (utils/calibrate.py; the
scheduler's calibrate_ladder task precedes the flagship), so the report
gets no calibration note.

    python -m tpu_reductions_torch.bench.experiment OUT [--dryrun] [--no-hazard]

--dryrun rehearses the whole flow on the CPU through the kernels' plain
versions at tiny sizes (grid n = 2^18, 2 repeats; curves to 2^14, 2^13,
2^14); its numbers are CPU numbers. --no-hazard leaves out the int32 2^30
cell. Without --dryrun and without a card this raises. Exit 0 when every
cell this run measured PASSED.

The script's steps begin at scripts/run_tpu_experiment.sh:72.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional

import torch

from tpu_reductions_torch.bench.pdf import generate_pdf
from tpu_reductions_torch.bench.plot import plot_vs_n
from tpu_reductions_torch.bench.regen import (PLOT_HLINES, PLOT_TITLE,
                                              collect_averages)
from tpu_reductions_torch.bench.report import generate_report, read_device
from tpu_reductions_torch.bench.roofline import annotate, summarize
from tpu_reductions_torch.bench.sweep import (FLAGSHIP_GRID, run_shmoo,
                                              sweep_all)
from tpu_reductions_torch.config import ReduceConfig
from tpu_reductions_torch.utils.jsonio import (atomic_json_dump,
                                               atomic_text_dump)
from tpu_reductions_torch.utils.logging import BenchLogger

# the curves: (dtype, largest power of two), in the JAX script's order;
# the int32 2^30 cell runs after them (HAZARD_POW)
CURVES = (("bfloat16", 30), ("float64", 28), ("int32", 29))
DRYRUN_CURVES = (("bfloat16", 14), ("float64", 13), ("int32", 14))
HAZARD_POW = 30
CURVE_MIN_POW = 10
DRYRUN_GRID = dict(n=1 << 18, repeats=2)


def device_line(dryrun: bool) -> str:
    """The card's name and power limit as nvidia-smi prints them (its
    first card), or the CPU's label for a dry run.
    The counterpart of the device kind the script reads
    (scripts/run_tpu_experiment.sh:234)."""
    if dryrun:
        return "cpu (--dryrun: the kernels' plain PyTorch versions)"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True, timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        smi = []
    return (smi[0].strip() if smi else
            f"{torch.cuda.get_device_name(0)}, power limit not read")


def curve_cfg(dtype: str, platform: str, dryrun: bool) -> ReduceConfig:
    """A curve's configuration: chained SUM through kernel 6 at the
    grid's tile, spans sized per cell (sweep.run_shmoo).
    The counterpart of step 3's configuration
    (scripts/run_tpu_experiment.sh:130)."""
    return ReduceConfig(method="SUM", dtype=dtype, n=1 << 20,
                        backend="cuda", kernel=6,
                        threads=FLAGSHIP_GRID["threads"], timing="chained",
                        chain_reps=2 if dryrun else 5, stat="median",
                        iterations=4096, platform=platform, log_file=None)


def run_experiment(out_dir: str | Path, *, dryrun: bool = False,
                   hazard: bool = True,
                   logger: Optional[BenchLogger] = None) -> dict:
    """Steps 1-3 of the module docstring into out_dir, logging each
    step's host seconds. Returns {grid, curve_results}: the grid's rows
    (resumed or measured) and the curve cells measured in this run.
    The counterpart of scripts/run_tpu_experiment.sh:72-226, steps 1-3."""
    if not dryrun and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; the experiment "
                           "runs on the card (--dryrun rehearses it on "
                           "the CPU)")
    platform = "cpu" if dryrun else "gpu"
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    log = logger or BenchLogger(None, None)
    seconds = {}
    device = device_line(dryrun)
    # the cached rows do not name their device, so a directory holding
    # another device's cells (a dry run's CPU rows, another card's) is
    # refused rather than resumed or mixed into this run's averages
    prior_device = read_device(out)
    if prior_device is not None and prior_device != device:
        raise RuntimeError(f"{out} holds cells measured on {prior_device}, "
                           f"not {device}; use another directory")
    atomic_text_dump(out / "device.txt", device + "\n")
    log.log(f"experiment: {device}")

    t0 = time.perf_counter()
    grid = dict(FLAGSHIP_GRID, **(DRYRUN_GRID if dryrun else {}))
    # redlint: disable=RED018 -- the experiment's wall seconds, printed as its duration; every cell's time is its own chained slope
    grid_rows = sweep_all(**grid, platform=platform,
                          out_dir=str(out / "single_chip"), logger=log)
    # averages from the cells on disk, those just measured and those
    # resumed; a dry run collects at its own n
    sc = collect_averages(out / "single_chip",
                          grid=grid if dryrun else None, log=log.log)
    atomic_json_dump(out / "single_chip" / "averages.json",
                     {f"{d} {m}": g for (d, m), g in sorted(sc.items())})
    seconds["grid"] = time.perf_counter() - t0

    # shmoo.json is merged, never erased: a fresh row replaces its
    # (dtype, n) predecessor, and every verified cell persists the moment
    # it lands, so a run cut short keeps every finished cell
    shmoo_file = out / "shmoo.json"
    prior = {}
    if shmoo_file.exists():
        try:
            for r in json.loads(shmoo_file.read_text()):
                prior[(r["dtype"], r["n"])] = r
        except (ValueError, KeyError, TypeError):
            prior = {}
    fresh: dict = {}

    def merged_rows() -> List[dict]:
        return [row for _, row in sorted({**prior, **fresh}.items())]

    def persist(_cfg, res) -> None:
        if res.passed:
            fresh[(res.dtype, res.n)] = res.to_dict()
            atomic_json_dump(shmoo_file, merged_rows())

    def make_plots():
        return plot_vs_n(merged_rows(), out / "bandwidth_vs_n",
                         title=PLOT_TITLE, hlines=PLOT_HLINES)

    def done_ns(dtype: str) -> set:
        """The sizes shmoo.json holds as verified rows of this curve's
        discipline (chained, kernel 6, the card's kernels)."""
        c = curve_cfg(dtype, platform, dryrun)
        return {n for (dt, n), r in prior.items()
                if dt == c.dtype and r.get("status") == "PASSED"
                and r.get("timing") == "chained"
                and r.get("kernel") == c.kernel
                and r.get("backend") == c.backend}

    curve_results = []
    figures = ()
    for dtype, max_pow in DRYRUN_CURVES if dryrun else CURVES:
        t0 = time.perf_counter()
        curve_results += run_shmoo(curve_cfg(dtype, platform, dryrun),
                                   min_pow=CURVE_MIN_POW, max_pow=max_pow,
                                   skip_ns=done_ns(dtype),
                                   on_result=persist, logger=log)
        figures = make_plots()
        seconds[f"curve {dtype}"] = time.perf_counter() - t0
    if hazard and not dryrun \
            and (1 << HAZARD_POW) not in done_ns("int32"):
        t0 = time.perf_counter()
        log.log(f"hazard cell: int32 n=2^{HAZARD_POW} (4 GiB, staged in "
                "chunks; last and alone)")
        curve_results += run_shmoo(curve_cfg("int32", platform, dryrun),
                                   min_pow=HAZARD_POW, max_pow=HAZARD_POW,
                                   on_result=persist, logger=log)
        figures = make_plots()
        seconds["hazard cell"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    shmoo_rows = merged_rows()
    kind = "cpu" if dryrun else torch.cuda.get_device_name(0)
    ann = annotate(shmoo_rows, device_kind=kind)
    roof_lines = summarize(ann)
    atomic_json_dump(out / "roofline.json", ann)
    paths = generate_report({}, single_chip=sc, figures=figures,
                            out_dir=out, platform=platform,
                            roofline=roof_lines, annotated_rows=ann,
                            device=device)
    log.log(f"report: {paths['md']} {paths['tex']}")
    pdf = generate_pdf(out, platform=platform,
                       data={"avgs": {}, "single_chip": sc or None,
                             "calibration": None, "figures": list(figures),
                             "roofline": roof_lines, "annotated_rows": ann,
                             "device": device})
    log.log(f"writeup: {pdf}")
    seconds["report"] = time.perf_counter() - t0
    log.log("experiment host seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items()))
    return {"grid": grid_rows, "curve_results": curve_results}


def main(argv=None) -> int:
    """CLI: the experiment into OUT, as scripts/run_tpu_experiment.sh:8 runs
    it."""
    p = argparse.ArgumentParser(
        prog="tpu_reductions_torch.bench.experiment",
        description="The flagship experiment on the card: the n = 2^24 "
                    "grid, the bandwidth-vs-N curves, and the report")
    p.add_argument("out_dir")
    p.add_argument("--dryrun", action="store_true",
                   help="rehearse on the CPU at tiny sizes (grid n = "
                        "2^18, 2 repeats; curves to 2^14/2^13/2^14)")
    p.add_argument("--no-hazard", dest="hazard", action="store_false",
                   help="leave out the int32 n = 2^30 (4 GiB) cell")
    ns = p.parse_args(argv)
    from tpu_reductions_torch.exec.core import maybe_arm
    maybe_arm("cpu" if ns.dryrun else "gpu")
    res = run_experiment(ns.out_dir, dryrun=ns.dryrun, hazard=ns.hazard)
    failed = ([r for r in res["grid"] if r["status"] != "PASSED"]
              + [r.to_dict() for r in res["curve_results"] if not r.passed])
    for r in failed:
        print(f"not PASSED: {r['dtype']} {r['method']} n={r['n']} "
              f"[{r['status']}] {r.get('waived_reason') or ''}",
              file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
