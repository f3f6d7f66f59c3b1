"""The compiled writeup, writeup.pdf, without a TeX stack.

The port's copy of tpu_reductions/bench/pdf.py:1. The reference ships its
writeup twice: the LaTeX source (writeup.tex:1-31) and the compiled
writeup.pdf. bench.report writes the source half (report.md and a
compilable report.tex); this module writes the PDF with matplotlib's
PdfPages backend, with the measured tables, the mechanical findings and
the bandwidth figures embedded (as writeup.tex:21-28 embeds its EPS
figures). Without matplotlib it prints a skip note and writes nothing.

Pages:
  1  title, the device line, the single-chip table against the reference
     GPU (mpi/CUdata.txt:2-8), the methodology notes
  2  roofline accounting and the mechanical findings (bench.findings)
  3+ one page per PNG bandwidth figure (bench.plot)
  (+ the collective rank-sweep table when the out_dir has one)

CLI:
    python -m tpu_reductions_torch.bench.pdf OUT [--out writeup.pdf] [--platform gpu]
"""

from __future__ import annotations

import datetime
import textwrap
from pathlib import Path
from typing import Dict, Optional, Sequence

from tpu_reductions_torch.bench.report import (REFERENCE_SINGLE_GPU,
                                               build_coll_rows, build_notes,
                                               build_sc_rows,
                                               load_experiment)

PAGE = (8.5, 11.0)   # US letter, matching the reference's article class
MARGIN = 0.07        # figure-fraction page margin


def _wrap(lines: Sequence[str], width: int = 88) -> list[str]:
    out: list[str] = []
    for ln in lines:
        out += textwrap.wrap(ln, width=width,
                             subsequent_indent="    ") or [""]
    return out


LINE_H = 0.0155      # page-fraction height of one monospace body line


def _text_page(pdf, title: str, blocks: Sequence[tuple[str, Sequence[str]]],
               footer: Optional[str] = None) -> None:
    """Render (section heading, monospace lines) blocks, PAGINATING when
    a block runs past the bottom margin — content must spill onto
    '(continued)' pages, never be dropped silently (a long collective
    table must not eat the Methodology note that the timing story rests
    on)."""
    import matplotlib.pyplot as plt

    def new_fig(cont: bool):
        fig = plt.figure(figsize=PAGE)
        fig.text(MARGIN, 1.0 - MARGIN,
                 f"{title} (continued)" if cont else title,
                 fontsize=16, fontweight="bold", va="top")
        return fig, 1.0 - MARGIN - 0.045

    def flush(fig):
        if footer:
            fig.text(MARGIN, MARGIN / 2, footer, fontsize=7,
                     color="0.35")
        pdf.savefig(fig)
        plt.close(fig)

    fig, y = new_fig(cont=False)
    for heading, lines in blocks:
        wrapped = _wrap(lines)
        i = 0
        while i < len(wrapped):
            # lines that fit above the bottom margin, after the heading
            fit = int((y - MARGIN - 0.03) // LINE_H) - 2
            if fit < 4 and y < 1.0 - MARGIN - 0.05:
                flush(fig)                 # page full: continue on a
                fig, y = new_fig(cont=True)  # fresh page, same title
                continue
            chunk = wrapped[i:i + max(fit, 4)]
            fig.text(MARGIN, y,
                     heading if i == 0 else f"{heading} (cont.)",
                     fontsize=12, fontweight="bold", va="top")
            y -= 0.03
            fig.text(MARGIN, y, "\n".join(chunk), fontsize=8.2,
                     family="monospace", va="top", linespacing=1.45)
            y -= LINE_H * len(chunk) + 0.03
            i += len(chunk)
    flush(fig)


def _figure_page(pdf, png: Path) -> None:
    import matplotlib.image as mpimg
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=PAGE)
    ax = fig.add_axes((MARGIN, 0.2, 1 - 2 * MARGIN, 0.62))
    ax.imshow(mpimg.imread(str(png)))
    ax.set_axis_off()
    fig.text(MARGIN, 0.86, f"Figure: {png.stem}", fontsize=12,
             fontweight="bold")
    pdf.savefig(fig)
    plt.close(fig)


def _single_chip_lines(single_chip: Optional[Dict[tuple, float]],
                       platform: str) -> list[str]:
    """Format the SHARED row assembly (report.build_sc_rows — same
    rows, order, and missing-cell placeholder as report.md/report.tex)
    as monospace table lines."""
    lines = [f"{'dtype':<8} {'op':<4} {'reference GPU':>14} "
             f"{'this framework (' + platform + ')':>26} {'ratio':>8}"]
    for dt, op, ref, ours in build_sc_rows(single_chip):
        lines.append(
            f"{dt:<8} {op:<4} {ref:>14.4f} "
            f"{format(ours, '26.4f') if ours else '—':>26} "
            f"{format(ours / ref, '.2f') + 'x' if ours else '—':>8}")
    return lines


def generate_pdf(out_dir: str | Path, pdf_path: str | Path | None = None,
                 platform: str = "gpu",
                 data: Optional[dict] = None) -> Optional[Path]:
    """Compile <out_dir>'s experiment data into writeup.pdf; nothing is
    measured again. Rows and notes come from the report's builders
    (report.build_*), so the three artifacts cannot disagree.

    `data` (a load_experiment-shaped dict) lets a live pipeline pass the
    results it just rendered into report.md; without it they are loaded
    from disk.

    Without matplotlib (as on a host that lacks it) this prints a skip
    note and returns None: the report and figures already written stand.
    The counterpart of tpu_reductions/bench/pdf.py:127.
    """
    try:
        import matplotlib
    except ImportError:
        print("writeup skipped (no matplotlib): writeup.pdf not built; "
              "report.md / report.tex carry the same rows")
        return None
    matplotlib.use("Agg")
    from matplotlib.backends.backend_pdf import PdfPages

    out = Path(out_dir)
    if data is None:
        data = load_experiment(out)
    pdf_path = Path(pdf_path) if pdf_path else out / "writeup.pdf"
    date = datetime.date.today().isoformat()

    with PdfPages(str(pdf_path)) as pdf:
        blocks = [
            ("Single-chip reductions vs the reference GPU (n=2^24)",
             [f"Device: {data.get('device') or 'not recorded'}", ""]
             + _single_chip_lines(data["single_chip"], platform)),
        ]
        if data["avgs"]:
            coll = [f"{'dtype':<8} {'op':<4} {'ranks':>6} {'GB/s':>10}"]
            coll += [f"{dt:<8} {op:<4} {ranks:>6} {gbps:>10.3f}"
                     for dt, op, ranks, gbps
                     in build_coll_rows(data["avgs"])]
            blocks.append(("Collective reductions vs rank count", coll))
        blocks.append(("Methodology", build_notes(data["calibration"])))
        _text_page(pdf, "GPU Reduction Benchmarks", blocks,
                   footer=f"Generated {date} by "
                          "tpu_reductions_torch.bench.pdf "
                          "(the compiled writeup.pdf analog; source twin: "
                          "report.md / report.tex)")

        second = []
        if data["roofline"]:
            second.append(("Roofline", list(data["roofline"])))
        if data["annotated_rows"] or data["single_chip"]:
            from tpu_reductions_torch.bench.findings import \
                derive_findings
            finds = derive_findings(rows=data["annotated_rows"],
                                    single_chip=data["single_chip"],
                                    coll_avgs=data["avgs"],
                                    reference=REFERENCE_SINGLE_GPU)
            if finds:
                second.append(("Findings (derived mechanically from "
                               "the measured rows)", finds))
        if second:
            _text_page(pdf, "Analysis", second)

        for png in [f for f in data["figures"]
                    if str(f).endswith(".png")]:
            _figure_page(pdf, Path(png))

        meta = pdf.infodict()
        meta["Title"] = "GPU Reduction Benchmarks"
        meta["Subject"] = ("Generated writeup: single-chip + collective "
                           "reduction bandwidth vs the reference")
        meta["Creator"] = "tpu_reductions_torch.bench.pdf"
    return pdf_path


def main(argv=None) -> int:
    """CLI: compile writeup.pdf from an experiment out_dir: the pdflatex
    step of the reference's pipeline (writeup.tex:1-31), in
    matplotlib."""
    import argparse

    p = argparse.ArgumentParser(
        prog="tpu_reductions_torch.bench.pdf",
        description="Compile an experiment out_dir into writeup.pdf "
                    "(no TeX needed; nothing is re-benchmarked)")
    p.add_argument("out_dir")
    p.add_argument("--out", type=str, default=None,
                   help="PDF path (default <out_dir>/writeup.pdf)")
    p.add_argument("--platform", type=str, default="gpu")
    ns = p.parse_args(argv)
    try:
        path = generate_pdf(ns.out_dir, pdf_path=ns.out,
                            platform=ns.platform)
    except FileNotFoundError as e:
        p.error(str(e))
    if path is not None:
        print(f"writeup: {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
