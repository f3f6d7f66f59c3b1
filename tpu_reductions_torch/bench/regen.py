"""Offline regeneration of an experiment's report artifacts.

The port's copy of tpu_reductions/bench/regen.py:1. bench/experiment.py
writes report.md, report.tex and writeup.pdf only at its own end, so a
run cut short leaves fresh grid cells and curve rows under a stale
report, and bench/seed_cache.py can add grid cells with no experiment
run at all. This re-collates everything from disk: averages from the
grid's cells, curves from shmoo.json, the roofline annotation, figures,
report and PDF (the reference's getAvgs.sh and makePlots.gp over its
accumulated stdout files). It touches no device.

The grid's averages prefer cells measured under the flagship contract
(sweep.FLAGSHIP_GRID); for a (dtype, op) with none, they fall back to the
PASSED cells of another discipline at the flagship geometry, and say so.

Of the JAX regenerator's report folds, the stream probes' table, the
reduction family's (family_spot.json), the serving curve and the
fleet's three artifacts (serving_curve.json, serving_scale.json,
serving_elastic.json, serving_recovery.json: serve/loadgen.py), the
execution core's decision
audit (exec_decisions.json, `python -m tpu_reductions_torch.exec
--explain --out`), the two rank-axis curves (quant_curve.json,
reshard_curve.json), the flight recorder's window summary
(obs_timeline.json, `python -m tpu_reductions_torch.obs.timeline LEDGER
--json`), the scheduler's plan against its actuals (sched_state.json)
and the compile observatory's cold/warm table (compile_ledger.json,
bench/warm.py) are here, each read from the experiment dir or from
its sibling `rank_scaling/`, where bench/rank_scaling.py writes the
curves. Its cross-round
trajectory table is left out: the rounds it collates are TPU runs.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Tuple

from tpu_reductions_torch.bench.sweep import FLAGSHIP_GRID, cell_matches
from tpu_reductions_torch.utils.jsonio import (atomic_json_dump,
                                               atomic_text_dump)

# the curves' figure: its title and constant lines, the reference GPU's
# int SUM rate and the card's HBM roof (bench/roofline.py)
PLOT_TITLE = "H100 single-chip reduction bandwidth vs N"
PLOT_HLINES = {"reference CUDA int SUM (90.8)": 90.8413,
               "H100 HBM roof (3350)": 3350.0}
_DTYPE_LABEL = {"int32": "INT", "float64": "DOUBLE"}


def collect_averages(grid_dir: Path, grid: dict | None = None,
                     log=print) -> Dict[Tuple[str, str], float]:
    """{(DATATYPE, OP): mean GB/s} from the grid's cells: contract
    cells first, other PASSED cells at the flagship geometry as the
    fallback that the log names.
    The counterpart of tpu_reductions/bench/regen.py:43."""
    grid = dict(grid or FLAGSHIP_GRID)
    contract = {k: grid[k] for k in ("n", "backend", "kernel", "threads",
                                     "iterations", "timing",
                                     "chain_reps")}
    matching: Dict[Tuple[str, str], List[float]] = {}
    legacy: Dict[Tuple[str, str], List[float]] = {}
    for f in sorted((grid_dir / "raw_output").glob("run-*.json")):
        try:
            row = json.loads(f.read_text())
        except (OSError, ValueError):
            continue
        method, dtype = row.get("method"), row.get("dtype")
        gbps = row.get("gbps")
        if (row.get("status") != "PASSED" or not method or not dtype
                or not isinstance(gbps, (int, float))):
            continue
        key = (_DTYPE_LABEL.get(dtype, dtype.upper()), method)
        if cell_matches(row, method=method, dtype=dtype, **contract):
            matching.setdefault(key, []).append(float(gbps))
        elif (row.get("n") == contract["n"]
              and row.get("kernel") == contract["kernel"]
              and row.get("threads") == contract["threads"]
              and row.get("backend") == contract["backend"]):
            # another discipline at the flagship geometry only: a cell at
            # another n, kernel, tile or backend never enters the table
            legacy.setdefault(key, []).append(float(gbps))
    out = {}
    for key in sorted(set(matching) | set(legacy)):
        vals = matching.get(key) or legacy.get(key)
        out[key] = sum(vals) / len(vals)
        if key not in matching:
            log(f"regen: {key[0]} {key[1]}: no contract-matching cells; "
                f"averaging {len(vals)} legacy row(s)")
    return out


def _quant_curve_table(data: dict) -> str:
    from tpu_reductions_torch.bench.quant_curve import quant_curve_markdown
    return quant_curve_markdown(data)


def _serving_curve_table(data: dict) -> str:
    from tpu_reductions_torch.serve.loadgen import curve_markdown
    return curve_markdown(data)


def _fleet_table(name: str):
    """The load generator's fold of a fleet artifact (serving_scale,
    serving_elastic, serving_recovery)."""
    def fold(data: dict) -> str:
        from tpu_reductions_torch.serve import loadgen
        return getattr(loadgen, f"{name}_markdown")(data)
    return fold


def _decisions_table(data: dict) -> str:
    from tpu_reductions_torch.exec.cost import decisions_markdown
    return decisions_markdown(data)


def _timeline_table(data: dict) -> str:
    from tpu_reductions_torch.obs.timeline import summary_markdown
    return summary_markdown(data)


def _sched_table(data: dict) -> str:
    from tpu_reductions_torch.sched.state import plan_vs_actual_markdown
    return plan_vs_actual_markdown(data)


def _compile_table(data: dict) -> str:
    from tpu_reductions_torch.obs.compile import compile_markdown
    return compile_markdown(data)


def _reshard_curve_table(data: dict) -> str:
    from tpu_reductions_torch.bench.reshard_curve import \
        reshard_curve_markdown
    return reshard_curve_markdown(data)


def regenerate(out_dir: str | Path, device_kind: str | None = None,
               log=print) -> bool:
    """Re-collate out_dir's report artifacts from disk. Returns False,
    and does nothing, when out_dir holds no experiment data.
    The counterpart of tpu_reductions/bench/regen.py:169."""
    out = Path(out_dir)
    grid_dir = out / "single_chip"
    shmoo_file = out / "shmoo.json"
    if not grid_dir.is_dir() and not shmoo_file.exists():
        log(f"regen: {out}: no experiment data (no single_chip/, no "
            "shmoo.json); nothing to do")
        return False

    from tpu_reductions_torch.bench.pdf import generate_pdf
    from tpu_reductions_torch.bench.plot import plot_vs_n
    from tpu_reductions_torch.bench.report import (generate_report,
                                                   read_device)
    from tpu_reductions_torch.bench.roofline import annotate, summarize
    from tpu_reductions_torch.bench.stream import stream_markdown

    cal = None
    cal_file = out / "calibration.json"
    if cal_file.exists():
        try:
            cal = json.loads(cal_file.read_text())
        except (OSError, ValueError):
            cal = None
    platform = (cal or {}).get("platform", "gpu")

    sc = collect_averages(grid_dir, log=log) if grid_dir.is_dir() else {}
    if sc:
        atomic_json_dump(
            grid_dir / "averages.json",
            {f"{d} {m}": g for (d, m), g in sorted(sc.items())})

    shmoo_rows: List[dict] = []
    if shmoo_file.exists():
        try:
            shmoo_rows = json.loads(shmoo_file.read_text())
        except (OSError, ValueError):
            shmoo_rows = []

    figures = ()
    if shmoo_rows:
        figures = plot_vs_n(shmoo_rows, out / "bandwidth_vs_n",
                            title=PLOT_TITLE, hlines=PLOT_HLINES)
    if device_kind is None:
        # the kind the live run recorded, so a regeneration never
        # relabels the hardware
        try:
            ann_prior = json.loads((out / "roofline.json").read_text())
            device_kind = ann_prior[0]["device_kind"]
        except (OSError, ValueError, LookupError, TypeError, KeyError):
            device_kind = None
    ann = annotate(shmoo_rows, device_kind=device_kind)
    roof_lines = summarize(ann)
    if ann:
        atomic_json_dump(out / "roofline.json", ann)

    device = read_device(out)
    paths = generate_report({}, single_chip=sc, figures=figures,
                            out_dir=out, platform=platform,
                            calibration=cal, roofline=roof_lines,
                            annotated_rows=ann, device=device)
    log(f"regen: report: {paths['md']} {paths['tex']}")
    # the streaming probes' artifacts, where the experiment dir has them
    probes = {}
    for name in ("stream_probe", "stream_hazard"):
        pf = out / f"{name}.json"
        if pf.exists():
            try:
                probes[name] = json.loads(pf.read_text())
            except (OSError, ValueError):
                log(f"regen: {name}.json unusable; skipped")
    if probes:
        try:
            table = stream_markdown(probes)
        except (KeyError, TypeError) as e:
            log(f"regen: stream probes unusable ({e}); skipped")
        else:
            atomic_text_dump(paths["md"], paths["md"].read_text()
                             + "\n" + table + "\n")
            log(f"regen: appended streaming-pipeline table "
                f"({', '.join(sorted(probes))})")
    # the reduction family's spot grid, where the dir has it
    fs_file = out / "family_spot.json"
    if fs_file.exists():
        from tpu_reductions_torch.bench.family_spot import \
            family_spot_markdown
        try:
            table = family_spot_markdown(json.loads(fs_file.read_text()))
        except (OSError, ValueError, KeyError, TypeError) as e:
            log(f"regen: family_spot.json unusable ({e}); skipped")
        else:
            if table:
                atomic_text_dump(paths["md"], paths["md"].read_text()
                                 + "\n" + table + "\n")
                log("regen: appended the reduction-family table "
                    "(family_spot.json)")
    for name, fold in (("serving_curve", _serving_curve_table),
                       ("serving_scale", _fleet_table("scale")),
                       ("serving_elastic", _fleet_table("elastic")),
                       ("serving_recovery", _fleet_table("recovery")),
                       ("exec_decisions", _decisions_table),
                       ("quant_curve", _quant_curve_table),
                       ("reshard_curve", _reshard_curve_table),
                       ("obs_timeline", _timeline_table),
                       ("sched_state", _sched_table),
                       ("compile_ledger", _compile_table)):
        # an experiment dir's own copy wins over the sibling rank_scaling/
        src = out / f"{name}.json"
        if not src.exists():
            src = out.parent / "rank_scaling" / f"{name}.json"
        if not src.exists():
            continue
        try:
            table = fold(json.loads(src.read_text()))
        except (OSError, ValueError, KeyError, TypeError) as e:
            log(f"regen: {name}.json unusable ({e}); skipped")
            continue
        if table:
            atomic_text_dump(paths["md"], paths["md"].read_text()
                             + "\n" + table + "\n")
            log(f"regen: appended the {name} table ({src})")
    pdf = generate_pdf(out, platform=platform,
                       data={"avgs": {}, "single_chip": sc or None,
                             "calibration": cal,
                             "figures": list(figures),
                             "roofline": roof_lines,
                             "annotated_rows": ann, "device": device})
    log(f"regen: writeup: {pdf}")
    return True


def main(argv=None) -> int:
    """CLI: re-collate an experiment dir from its on-disk data, with no
    device.

        python -m tpu_reductions_torch.bench.regen OUT [--device-kind KIND]
    The counterpart of tpu_reductions/bench/regen.py:450.
    """
    p = argparse.ArgumentParser(
        prog="tpu_reductions_torch.bench.regen",
        description="Regenerate an experiment dir's report artifacts "
                    "from its on-disk data (offline; no device)")
    p.add_argument("out_dir")
    p.add_argument("--device-kind", default=None,
                   help="roofline hardware label override (default: "
                        "whatever the live run recorded)")
    ns = p.parse_args(argv)
    regenerate(ns.out_dir, device_kind=ns.device_kind,
               log=lambda m: print(m, file=sys.stderr))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
