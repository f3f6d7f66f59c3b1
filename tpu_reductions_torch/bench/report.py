"""The generated report: the reference's writeup.tex.

The port's copy of tpu_reductions/bench/report.py:1. The reference's
terminal artifact is a LaTeX report embedding its two EPS bandwidth
figures with a findings narrative (writeup.tex:1-31, figures at :21-28).
Here the report is generated from the measured data: report.md and a
compilable report.tex with the same content, embedding bench.plot's
figures, bench.aggregate's averaged tables and the comparison with the
reference GPU that the writeup drew by hand. The report names the card
and its power limit (`device`), and notes that float64 runs natively on
the card, where the JAX package's report notes its pair route.
"""

from __future__ import annotations

import datetime
from pathlib import Path
from typing import Dict, Optional, Sequence

from tpu_reductions_torch.bench.aggregate import Key
from tpu_reductions_torch.utils.jsonio import atomic_text_dump
# the collective table's columns are the emitted rows' own
from tpu_reductions_torch.utils.logging import COLLECTIVE_COLUMNS

# Reference headline numbers (BASELINE.md; mpi/CUdata.txt:2-8) for the
# comparison table the writeup's narrative was built around.
REFERENCE_SINGLE_GPU = {
    ("INT", "SUM"): 90.8413, ("INT", "MIN"): 90.7905, ("INT", "MAX"): 90.7969,
    ("DOUBLE", "SUM"): 92.7729, ("DOUBLE", "MIN"): 92.6014,
    ("DOUBLE", "MAX"): 92.7552,
}


def _calibration_note(cal: Optional[dict]) -> str:
    """One bullet on the timing methodology the numbers rest on, from a
    calibration record (utils/calibrate.py; bench/experiment.py passes
    None: the calibration runs as its own CLI)."""
    if not cal:
        return ""
    if cal.get("block_awaits_execution"):
        how = ("the platform's sync primitive awaits execution; "
               "per-launch synced timing is valid")
    else:
        how = ("the platform's sync primitive does NOT await execution "
               "(blocked launch {:.0f} us vs {:.0f} us true per-iteration"
               " cost); bandwidths use the chained slope mode wherever "
               "the reduce is all-device (every dtype, including f64 "
               "via the device pair-tree finish) — only --cpufinal "
               "rows, host work by definition, fall back to per-launch "
               "timing and carry that caveat"
               .format(cal.get("single_blocked_s", 0) * 1e6,
                       cal.get("chained_per_iter_s", 0) * 1e6))
    return ("- Timing calibration ({} platform): {}.\n"
            .format(cal.get("platform", "?"), how))


def build_sc_rows(single_chip: Optional[Dict[tuple, float]]
                  ) -> list[tuple[str, str, float, Optional[float]]]:
    """(dtype, op, reference_gbps, ours_gbps|None) in the canonical
    order: the one single-chip row assembly shared by the md/tex
    renderer (generate_report) and the PDF (bench.pdf), so the three
    artifacts cannot disagree on rows, order or missing cells. The
    writeup's CUDA comparison rows (mpi/CUdata.txt:2-8; overlay
    constants makePlots.gp:17-19,31-33)."""
    return [(dt, op, ref, (single_chip or {}).get((dt, op)))
            for (dt, op), ref in sorted(REFERENCE_SINGLE_GPU.items())]


def build_coll_rows(avgs: Dict[Key, float]
                    ) -> list[tuple[str, str, int, float]]:
    """(dtype, op, ranks, gbps) in the canonical order — the shared
    collective row assembly (same contract as build_sc_rows).
    Re-creates the averaged `DATATYPE OP NODES GB/sec` rows of
    mpi/results/*.txt (getAvgs.sh:8-14)."""
    return [(dt, op, ranks, gbps)
            for (dt, op, ranks), gbps in sorted(avgs.items())]


def build_notes(calibration: Optional[dict]) -> list[str]:
    """The methodology notes, shared by report.md's Notes section and
    the PDF's Methodology block: the reference driver's oracle check
    (reduction.cpp:748-780), float64's route on the card, and the timing
    calibration when there is one."""
    notes = [
        "Verification: every single-chip number is oracle-checked "
        "(Kahan host reference); collective numbers are checked "
        "against an elementwise host oracle. Failed runs report 0 "
        "and are excluded.",
        "float64 runs natively on the card (8 bytes per element); "
        "--f64=dd takes the double-double / order-key 32-bit-pair "
        "route instead, with the same bytes per element.",
    ]
    cal_note = _calibration_note(calibration).strip()
    if cal_note.startswith("- "):
        cal_note = cal_note[2:]
    if cal_note:
        notes.append(cal_note)
    return notes


def _table(rows: Sequence[Sequence[str]], header: Sequence[str]) -> str:
    out = ["| " + " | ".join(header) + " |",
           "|" + "|".join("---" for _ in header) + "|"]
    out += ["| " + " | ".join(str(c) for c in r) + " |" for r in rows]
    return "\n".join(out)


def generate_report(avgs: Dict[Key, float],
                    single_chip: Optional[Dict[tuple, float]] = None,
                    figures: Sequence[str | Path] = (),
                    out_dir: str | Path = ".",
                    platform: str = "gpu",
                    calibration: Optional[dict] = None,
                    roofline: Optional[Sequence[str]] = None,
                    annotated_rows: Optional[Sequence[dict]] = None,
                    findings: Optional[Sequence[str]] = None,
                    device: Optional[str] = None
                    ) -> Dict[str, Path]:
    """Render report.md + report.tex from averaged collective results
    (aggregate.average output) and optional single-chip numbers
    {(DATATYPE, OP): GB/s}. `calibration`, when given, documents whether
    the platform's sync could be trusted. `device` is the card's name and
    power limit as nvidia-smi prints them. Returns {"md": path, "tex":
    path}, both written atomically.

    The Findings section (bench.findings, writeup.tex:19's narrative
    derived from the data) is computed here from what every caller
    passes (avgs, single_chip, optional roofline-annotated shmoo rows),
    so no pipeline ships curves without the analysis; `findings`
    overrides the derivation."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    date = datetime.date.today().isoformat()

    if findings is None:
        from tpu_reductions_torch.bench.findings import derive_findings
        findings = derive_findings(rows=annotated_rows,
                                   single_chip=single_chip,
                                   coll_avgs=avgs,
                                   reference=REFERENCE_SINGLE_GPU) or None

    # ---- tables (rows built by the shared builders) ----------------------
    coll_rows = [(dt, op, ranks, f"{gbps:.3f}")
                 for dt, op, ranks, gbps in build_coll_rows(avgs)]
    coll_tbl = _table(coll_rows, [c.lower() if c.isalpha() else c
                                  for c in COLLECTIVE_COLUMNS])

    sc_rows = []
    for dt, op, ref, ours in build_sc_rows(single_chip):
        ratio = f"{ours / ref:.2f}x" if ours else "—"
        sc_rows.append((dt, op, f"{ref:.4f}",
                        f"{ours:.4f}" if ours else "—", ratio))
    sc_tbl = _table(sc_rows, ["dtype", "op", "reference GPU GB/s",
                              f"this framework ({platform}) GB/s", "ratio"])

    fig_md = "\n\n".join(f"![{Path(f).stem}]({Path(f).name})"
                         for f in figures)

    # a single-card run has no rank sweep: omit the section rather than
    # print a bare header over an empty table
    coll_md = ("\n## Collective reductions vs rank count\n\n"
               "Averaged over repeats (reference convention: total "
               "payload bytes /\nwall time — reduce.c:79 analog with "
               "real clocks).\n\n" + coll_tbl + "\n") if coll_rows else ""

    roof_md = ("\n## Roofline\n\n"
               + "\n".join(f"- {ln}" for ln in roofline) + "\n"
               ) if roofline else ""

    # mechanical findings (bench.findings) — the writeup.tex:19
    # narrative derived from the data instead of written by hand
    find_md = ("\n## Findings\n\n"
               + "\n".join(f"- {ln}" for ln in findings) + "\n"
               ) if findings else ""

    md = f"""# GPU Reduction Benchmarks — generated report

*Generated {date} by tpu_reductions_torch.bench.report (the writeup.tex analog).*

## Single-chip reductions vs the reference GPU

The reference measured a single CC≥1.3 GPU at n=2^24 elements
(mpi/CUdata.txt); this framework measures one card with the hand-written
CUDA kernel path at the same n.

Device: {device or "not recorded"}.

{sc_tbl}
{coll_md}{roof_md}{find_md}
{fig_md}

## Notes

{chr(10).join("- " + n for n in build_notes(calibration))}
"""
    md_path = out / "report.md"
    atomic_text_dump(md_path, md)

    tex = _to_tex(sc_rows, coll_rows, figures, date,
                  calibration=calibration, roofline=roofline,
                  findings=findings, device=device)
    tex_path = out / "report.tex"
    atomic_text_dump(tex_path, tex)
    return {"md": md_path, "tex": tex_path}


def _to_tex(sc_rows, coll_rows, figures, date, calibration=None,
            roofline=None, findings=None, device=None) -> str:
    def tabular(rows, cols, header):
        lines = ["\\begin{tabular}{" + "l" * cols + "}",
                 " & ".join(header) + " \\\\ \\hline"]
        lines += [" & ".join(str(c) for c in r) + " \\\\" for r in rows]
        lines.append("\\end{tabular}")
        return "\n".join(lines)

    figs = "\n".join(
        "\\includegraphics[width=0.85\\textwidth]{%s}" % Path(f).name
        for f in figures if str(f).endswith(".eps"))
    # precomputed outside the f-string: backslashes are not allowed in
    # f-string expressions before Python 3.12
    coll_tex = ("\\section{Collective reductions}\n"
                + tabular(coll_rows, 4, ["dtype", "op", "ranks", "GB/s"])
                if coll_rows else "")
    roof_tex = ("\\section{Roofline}\n\\begin{itemize}\n"
                + "\n".join(f"\\item {_tex_escape(ln)}"
                             for ln in roofline)
                + "\n\\end{itemize}"
                if roofline else "")
    find_tex = ("\\section{Findings}\n\\begin{itemize}\n"
                + "\n".join(f"\\item {_tex_escape(ln)}"
                             for ln in findings)
                + "\n\\end{itemize}"
                if findings else "")
    return f"""\\documentclass{{article}}
\\usepackage{{graphicx}}
\\title{{GPU Reduction Benchmarks}}
\\date{{{date}}}
\\begin{{document}}
\\maketitle
\\section{{Single-chip reductions}}
Device: {_tex_escape(device or "not recorded")}.

{tabular(sc_rows, 5, ["dtype", "op", "ref GPU", "GPU", "ratio"])}
{coll_tex}
{roof_tex}
{find_tex}
\\section{{Figures}}
{figs}
\\section{{Methodology}}
{_tex_escape(_calibration_note(calibration)) or
 "Timing: each row's recorded discipline (the grid and the curves: "
 "chained slope timing); the card's synchronize awaits execution."}
\\end{{document}}
"""


def _tex_escape(s: str) -> str:
    # '^' appears in every power-of-two finding/roofline line (2^24);
    # bare it breaks compilation ('Missing $ inserted') — the module
    # promises a COMPILABLE LaTeX source
    return (s.replace("&", "\\&").replace("%", "\\%")
             .replace("#", "\\#").replace("_", "\\_")
             .replace("^", "\\textasciicircum{}")
             .replace("->", "$\\rightarrow$"))


def load_experiment(out_dir: str | Path,
                    calibration: Optional[str] = None) -> dict:
    """Reload everything a report needs from an experiment out_dir (the
    reference's raw_output -> collected.txt -> results/ -> writeup,
    redone offline). Returns {avgs, single_chip, calibration, figures,
    roofline, annotated_rows, device}; shared by the md/tex regenerator
    (main) and the PDF (bench.pdf). Raises FileNotFoundError when the
    out_dir holds no experiment.
    The counterpart of tpu_reductions/bench/report.py:262."""
    import json

    from tpu_reductions_torch.bench.aggregate import average, collect

    out = Path(out_dir)
    raw = out / "raw_output"
    sc_raw = out / "single_chip" / "raw_output"
    if raw.is_dir():
        avgs = average(collect(raw))
    elif sc_raw.is_dir():
        # a single-card experiment has no collective rank sweep: an
        # empty collective section, not a refusal
        avgs = {}
    else:
        raise FileNotFoundError(
            f"neither {raw} nor {sc_raw} found — run the experiment "
            "pipeline first")

    # the single-chip averages from the sweep's cached cells
    sc: dict = {}
    if sc_raw.is_dir():
        for f in sorted(sc_raw.glob("*.json")):
            for line in f.read_text().splitlines():
                if not line.strip():
                    continue
                r = json.loads(line)
                if r.get("status") != "PASSED":
                    continue
                dt = {"int32": "INT", "float64": "DOUBLE"}.get(
                    r["dtype"], r["dtype"].upper())
                sc.setdefault((dt, r["method"]), []).append(r["gbps"])
        sc = {k: sum(v) / len(v) for k, v in sc.items()}

    cal_path = Path(calibration) if calibration \
        else out / "calibration.json"
    if calibration and not cal_path.exists():
        raise FileNotFoundError(f"{cal_path} not found")
    cal = json.loads(cal_path.read_text()) if cal_path.exists() else None

    roof_lines = None
    ann = None
    roof_path = out / "roofline.json"
    if roof_path.exists():
        from tpu_reductions_torch.bench.roofline import summarize
        ann = json.loads(roof_path.read_text())
        roof_lines = summarize(ann)
    return {"avgs": avgs, "single_chip": sc or None, "calibration": cal,
            "figures": sorted(out.glob("*.eps")) + sorted(out.glob("*.png")),
            "roofline": roof_lines, "annotated_rows": ann,
            "device": read_device(out)}


def read_device(out_dir: str | Path) -> Optional[str]:
    """The device line the live run recorded in <out_dir>/device.txt
    (bench/experiment.py), or None.
    The counterpart of the device kind the JAX script passes on
    (scripts/run_tpu_experiment.sh:234)."""
    try:
        return (Path(out_dir) / "device.txt").read_text().strip() or None
    except OSError:
        return None


def main(argv=None) -> int:
    """Regenerate the report offline from an experiment out_dir; nothing
    is measured again.

        python -m tpu_reductions_torch.bench.report OUT [--calibration cal.json]
    The counterpart of tpu_reductions/bench/report.py:324.
    """
    import argparse

    p = argparse.ArgumentParser(
        prog="tpu_reductions_torch.bench.report",
        description="Regenerate report.md/report.tex from an experiment "
                    "output directory (no benchmarks are re-run)")
    p.add_argument("out_dir", help="Directory holding raw_output/ or "
                                   "single_chip/raw_output/ of a sweep")
    p.add_argument("--calibration", type=str, default=None,
                   help="Path to a calibration JSON; defaults to "
                        "<out_dir>/calibration.json when present")
    p.add_argument("--platform", type=str, default="gpu",
                   help="Platform label for the comparison table")
    ns = p.parse_args(argv)

    try:
        data = load_experiment(ns.out_dir, calibration=ns.calibration)
    except FileNotFoundError as e:
        p.error(str(e))
    paths = generate_report(data["avgs"], single_chip=data["single_chip"],
                            figures=data["figures"], out_dir=ns.out_dir,
                            platform=ns.platform,
                            calibration=data["calibration"],
                            roofline=data["roofline"],
                            annotated_rows=data["annotated_rows"],
                            device=data["device"])
    print(f"report: {paths['md']} {paths['tex']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
