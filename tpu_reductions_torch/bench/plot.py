"""Figures: the reference's makePlots.gp.

The port's copy of tpu_reductions/bench/plot.py:1. The reference renders
EPS figures with gnuplot (mpi/makePlots.gp:1-39): per-dtype
bandwidth-vs-ranks curves for the three MPI ops, with the CUDA single-GPU
numbers overlaid as horizontal lines (`f(x)=90.8413`,
makePlots.gp:17-19,31-33), axes "Number of MPI Ranks" vs "Bandwidth
(GB/sec)" (:12-13). Those figures feed writeup.tex.

Here matplotlib writes PNG and EPS (the reference's format), plus a
bandwidth-vs-N figure of the shmoo sweep. Without matplotlib each plotter
writes a gnuplot script or a .dat file instead, so the pipeline always
leaves something plottable.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence

from tpu_reductions_torch.bench.aggregate import Key


def _mpl():
    """matplotlib.pyplot on the Agg backend, or None when matplotlib is
    unavailable — callers fall back to a gnuplot/.dat artifact (module
    docstring promise: the pipeline always produces something
    plottable)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except Exception:
        return None


def _finish_and_save(plt, fig, ax, *, xlabel: str, title: str,
                     out_base: Path,
                     ylabel: str = "Bandwidth (GB/sec)") -> list:
    """Shared figure grammar + emission for every plotter: the
    makePlots.gp axes (:12-13), log2 x, legend, grid, then PNG + EPS
    (the reference's format, makePlots.gp:1) — one copy, so styling
    cannot drift between the figures. ylabel defaults to the
    makePlots.gp:13 label; the shape plot overrides it (its y axis is
    a normalized ratio, not GB/s)."""
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)                        # makePlots.gp:13
    ax.set_xscale("log", base=2)
    ax.legend()
    ax.set_title(title)
    ax.grid(True, alpha=0.3)
    outs = []
    for ext in ("png", "eps"):                   # reference emits EPS
        p = out_base.with_suffix(f".{ext}")
        fig.savefig(p, bbox_inches="tight")
        outs.append(p)
    plt.close(fig)
    return outs


def plot_vs_ranks(avgs: Dict[Key, float], dtype_name: str,
                  out_base: str | Path,
                  single_chip_lines: Optional[Dict[str, float]] = None,
                  title: Optional[str] = None) -> Sequence[Path]:
    """One dtype's bandwidth-vs-ranks figure (int.eps / double.eps analog).

    single_chip_lines: {label: GB/s} constants drawn as horizontal lines,
    the reference's CUDA overlay, here carrying the single-card numbers.
    The counterpart of tpu_reductions/bench/plot.py:61.
    """
    series = {(dt, op): [] for (dt, op, _) in avgs if dt == dtype_name}
    for (dt, op, ranks), gbps in sorted(avgs.items()):
        if dt == dtype_name:
            series[(dt, op)].append((ranks, gbps))
    out_base = Path(out_base)
    plt = _mpl()
    if plt is None:
        return [_emit_gnuplot(series, dtype_name, out_base,
                              single_chip_lines)]

    fig, ax = plt.subplots(figsize=(7, 5))
    for (_, op), pts in sorted(series.items()):
        xs, ys = zip(*pts)
        ax.plot(xs, ys, marker="o", label=f"{dtype_name} {op}")
    if single_chip_lines:
        for label, gbps in single_chip_lines.items():
            ax.axhline(gbps, linestyle="--", linewidth=1, label=label)
    return _finish_and_save(
        plt, fig, ax, xlabel="Number of Mesh Ranks",  # makePlots.gp:12
        title=title or f"{dtype_name} collective reduction bandwidth",
        out_base=out_base)


def plot_vs_n(shmoo_rows: Sequence[dict], out_base: str | Path,
              title: str = "Single-chip reduction bandwidth vs N",
              hlines: Optional[Dict[str, float]] = None
              ) -> Sequence[Path]:
    """Bandwidth-vs-N curves from shmoo results (one line per
    (method, dtype)) — the sweep plot the reference's stubbed shmoo never
    produced. shmoo_rows: BenchResult.to_dict() dicts.

    hlines {label: GB/s} draws constant overlays — the makePlots.gp
    idiom of plotting fixed comparators as horizontal functions
    (f(x)=90.8413, makePlots.gp:17-19), used here for the reference
    baseline and the card's HBM roof."""
    out_base = Path(out_base)
    plt = _mpl()
    if plt is None:
        lines = [f"{r['dtype']} {r['method']} {r['n']} {r['gbps']:.3f}"
                 for r in shmoo_rows]
        lines += [f"# hline {label} {v:.3f}"
                  for label, v in (hlines or {}).items()]
        p = out_base.with_suffix(".dat")
        p.write_text("\n".join(lines) + "\n")
        return [p]

    groups: Dict[tuple, list] = {}
    for r in shmoo_rows:
        groups.setdefault((r["dtype"], r["method"]), []).append(
            (r["n"], r["gbps"]))
    fig, ax = plt.subplots(figsize=(7, 5))
    for (dtype, method), pts in sorted(groups.items()):
        xs, ys = zip(*sorted(pts))
        ax.plot(xs, ys, marker="o", label=f"{dtype} {method}")
    for i, (label, v) in enumerate(sorted((hlines or {}).items())):
        ax.axhline(v, linestyle="--", linewidth=1,
                   color=f"C{7 - (i % 3)}", alpha=0.8)
        ax.annotate(label, xy=(1, v), xycoords=("axes fraction", "data"),
                    xytext=(-4, 3), textcoords="offset points",
                    ha="right", fontsize=8)
    return _finish_and_save(plt, fig, ax, xlabel="Elements (N)",
                            title=title, out_base=out_base)


def _emit_gnuplot(series, dtype_name, out_base: Path,
                  single_chip_lines) -> Path:
    """matplotlib-free fallback: write a gnuplot script + data files in
    the reference's own idiom (constants as f(x)=..., makePlots.gp:17-19)."""
    gp = [f'set term postscript color\nset output "{out_base.stem}.eps"',
          'set xlabel "Number of Mesh Ranks"',
          'set ylabel "Bandwidth (GB/sec)"', "set logscale x 2"]
    plots, idx = [], 0
    for (dt, op), pts in sorted(series.items()):
        dat = out_base.parent / f"{out_base.stem}_{op}.dat"
        dat.write_text("\n".join(f"{r} {g}" for r, g in sorted(pts)) + "\n")
        plots.append(f'"{dat.name}" using 1:2 with linespoints '
                     f'title "{dt} {op}"')
        idx += 1
    for label, gbps in (single_chip_lines or {}).items():
        gp.append(f"f{idx}(x)={gbps}")
        plots.append(f'f{idx}(x) title "{label}"')
        idx += 1
    gp.append("plot " + ", ".join(plots))
    path = out_base.with_suffix(".gp")
    path.write_text("\n".join(gp) + "\n")
    return path


def plot_scaling_shape(series: Dict[str, Sequence[tuple]],
                       out_base: str | Path,
                       title: Optional[str] = None) -> Sequence[Path]:
    """Normalized scaling-shape comparison: every series divided by its
    own smallest-rank value, log-log — the only honest way to put a
    serialized virtual-mesh curve next to the reference's torus curves
    (mpi/results/*_SUM.txt rows at 64/256/1024 ranks), whose absolute
    GB/s differ by orders of magnitude and by meaning. A rising
    normalized curve = aggregate bandwidth grows with ranks; a falling
    one = per-rank costs dominate.

    series: {label: [(ranks, gbps), ...]}; empty/zero-lead series are
    skipped. Returns [] when nothing is plottable.
    The counterpart of tpu_reductions/bench/plot.py:161.
    """
    norm = {}
    for label, pts in series.items():
        pts = sorted(pts)
        if pts and pts[0][1] > 0:
            base = pts[0][1]
            norm[label] = [(r, g / base) for r, g in pts]
    if not norm:
        return []
    out_base = Path(out_base)
    plt = _mpl()
    if plt is None:
        lines = [f"# {label} (normalized to ranks={pts[0][0]})\n"
                 + "\n".join(f"{r} {g:.6f}" for r, g in pts)
                 for label, pts in sorted(norm.items())]
        p = out_base.with_suffix(".dat")
        p.write_text("\n\n".join(lines) + "\n")
        return [p]

    fig, ax = plt.subplots(figsize=(7, 5))
    for label, pts in sorted(norm.items()):
        xs, ys = zip(*pts)
        ax.plot(xs, ys, marker="o", label=label)
    ax.set_yscale("log")
    ax.axhline(1.0, linestyle=":", linewidth=1, color="0.5")
    return _finish_and_save(
        plt, fig, ax, xlabel="Number of Mesh Ranks",
        title=title or "Aggregate-bandwidth scaling shape "
                       "(normalized to each curve's smallest rank count)",
        out_base=out_base,
        ylabel="Bandwidth / bandwidth at smallest rank count")


def plot_vn_vs_co(avgs_by_mode: Dict[str, Dict[Key, float]],
                  dtype_name: str, method: str, out_base: str | Path,
                  title: Optional[str] = None) -> Sequence[Path]:
    """The virtual_node_interesting.eps analog: one (dtype, op) curve
    per node mode — VN (every addressable device is a rank) vs CO (one
    rank per chip) — the BG/L node-mode comparison the reference
    collected as stdout-vn-* vs stdout-co-* raw files
    (mpi/vn_co_collected.txt; modes set in ccni_vn.sh:6).

    avgs_by_mode: {mode_label: aggregate.average() dict}. Modes missing
    the requested (dtype, method) series are skipped; returns [] when
    nothing can be plotted (e.g. too few devices for a CO sweep)."""
    series = {}
    for label, avgs in avgs_by_mode.items():
        pts = [(ranks, gbps) for (dt, op, ranks), gbps
               in sorted(avgs.items())
               if dt == dtype_name and op == method]
        if pts:
            series[label] = pts
    if not series:
        return []
    out_base = Path(out_base)
    plt = _mpl()
    if plt is None:
        lines = [f"# {label}\n" + "\n".join(f"{r} {g}" for r, g in pts)
                 for label, pts in sorted(series.items())]
        p = out_base.with_suffix(".dat")
        p.write_text("\n\n".join(lines) + "\n")
        return [p]

    fig, ax = plt.subplots(figsize=(7, 5))
    for label, pts in sorted(series.items()):
        xs, ys = zip(*pts)
        ax.plot(xs, ys, marker="o", label=label)
    return _finish_and_save(
        plt, fig, ax, xlabel="Number of Mesh Ranks",
        title=title or f"{dtype_name} {method}: VN vs CO node mode",
        out_base=out_base)
