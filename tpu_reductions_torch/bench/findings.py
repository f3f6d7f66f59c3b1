"""Mechanical findings: the writeup's narrative, derived from the rows.

The port's copy of tpu_reductions/bench/findings.py:1. The reference's
writeup closes with observations written by hand (writeup.tex:19: CUDA
beats Blue Gene on doubles until about 1024 ranks, Blue Gene overtakes
CUDA on ints near 500-600 ranks). This module derives the same kinds of
observation from the measured rows, so a generated report never ships
curves without their analysis:

- each curve's half-power point N_1/2: the smallest N reaching half the
  curve's large-N rate, below which a row measures launch and host cost,
  not memory bandwidth;
- the L2 -> HBM cliff (`l2_cliff`, the counterpart of
  `findings.vmem_cliff`): the N where a chained working set no longer
  fits the card's L2 (bench/roofline.py) and the rate across it;
- the single-chip averages as multiples of the reference GPU's
  (makePlots.gp:17-19,31-33);
- the rank count where a collective overtakes one chip.

Every function takes plain row dicts and returns prose lines for the
report's Findings section.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


def pow2_label(n: int) -> str:
    """'2^k' for exact powers of two, the literal value otherwise: the
    sweep's sizes are powers of two (bench.sweep.run_shmoo), but a
    floored label for anything else would name a size that never ran.
    The counterpart of tpu_reductions/bench/findings.py:31."""
    n = int(n)
    if n > 0 and n & (n - 1) == 0:
        return f"2^{n.bit_length() - 1}"
    return str(n)


def _curves(rows: Sequence[dict]) -> Dict[Tuple[str, str], List[dict]]:
    out: Dict[Tuple[str, str], List[dict]] = {}
    for r in rows:
        out.setdefault((r["dtype"], r["method"]), []).append(r)
    for pts in out.values():
        pts.sort(key=lambda r: r["n"])
    return out


def half_power_points(shmoo_rows: Sequence[dict]) -> List[str]:
    """Per curve: the smallest N whose rate reaches half the curve's
    ASYMPTOTIC (large-N) rate — the classic N_1/2 latency/bandwidth
    crossover; below it the benchmark measures launch/dispatch latency,
    not memory bandwidth.

    The reference rate is not the curve's peak: the peak may sit in the
    L2-resident regime (bench.roofline), above the HBM rate of every
    large payload, and half of it would call bandwidth-bound HBM rows
    "dispatch-bound". With regime tags present, the asymptote is the
    median HBM-bound rate; without them, the largest-N row's rate.
    The counterpart of tpu_reductions/bench/findings.py:53.
    """
    import statistics

    lines = []
    for (dtype, method), pts in sorted(_curves(shmoo_rows).items()):
        if len(pts) < 3:
            continue
        hbm = [r["gbps"] for r in pts if r.get("regime") == "hbm_bound"]
        asym = statistics.median(hbm) if hbm else pts[-1]["gbps"]
        if asym <= 0:
            continue
        # guaranteed to match: every row at/above the asymptote's own
        # source rows satisfies the threshold
        n_half = next(r["n"] for r in pts if r["gbps"] >= asym / 2)
        lines.append(
            f"{dtype} {method}: half-power point N_1/2 = "
            f"{pow2_label(n_half)} (half the "
            f"{asym:.0f} GB/s large-N rate) — smaller payloads are "
            "dispatch-bound, not bandwidth-bound.")
    return lines


def l2_cliff(annotated_rows: Sequence[dict]) -> List[str]:
    """The regime boundary of roofline-annotated rows (bench.roofline tags
    each row l2_resident or hbm_bound): the last L2-resident N, the first
    HBM-bound N and the rates across them. The counterpart of
    findings.vmem_cliff, whose TPU boundary is its VMEM.
    See tpu_reductions/bench/findings.py:89."""
    lines = []
    for (dtype, method), pts in sorted(_curves(annotated_rows).items()):
        last_l2: Optional[dict] = None
        first_hbm: Optional[dict] = None
        for r in pts:
            if r.get("regime") == "l2_resident":
                last_l2 = r
            elif r.get("regime") == "hbm_bound" and first_hbm is None:
                first_hbm = r
        if last_l2 and first_hbm and first_hbm["gbps"] > 0:
            ratio = last_l2["gbps"] / first_hbm["gbps"]
            lines.append(
                f"{dtype} {method}: L2->HBM cliff between "
                f"{pow2_label(last_l2['n'])} and "
                f"{pow2_label(first_hbm['n'])} — "
                f"{last_l2['gbps']:.0f} GB/s L2-resident vs "
                f"{first_hbm['gbps']:.0f} GB/s HBM-bound "
                f"({ratio:.1f}x drop at the residency boundary).")
    return lines


def reference_multiples(single_chip: Dict[tuple, float],
                        reference: Dict[tuple, float]) -> List[str]:
    """Single-chip averages vs the reference GPU's published numbers
    (mpi/CUdata.txt:2-8) — the writeup's central comparison, as
    multiples."""
    lines = []
    ratios = {}
    for key, gbps in sorted(single_chip.items()):
        ref = reference.get(key)
        if ref:
            ratios[key] = gbps / ref
    if not ratios:
        return lines
    lo, hi = min(ratios.values()), max(ratios.values())
    worst = min(ratios, key=ratios.get)
    best = max(ratios, key=ratios.get)
    # 2 significant figures: fixed .1f would collapse every CPU-demo /
    # fetch-mode ratio to an uninformative "0.0x"
    lines.append(
        f"Single-chip vs the reference GPU: {lo:.2g}x "
        f"({' '.join(worst)}) to {hi:.2g}x ({' '.join(best)}) across "
        f"the measured (dtype, op) grid.")
    under = [k for k, v in ratios.items() if v < 1.0]
    if under:
        lines.append(
            "BELOW the reference on: "
            + ", ".join(" ".join(k) for k in sorted(under))
            + " — check those rows' recorded timing discipline "
            "(BenchResult.timing in the raw data) before reading this "
            "as chip performance: fetch-mode rows time host transfer "
            "too.")
    return lines


def collective_crossover(coll_avgs: Dict[tuple, float],
                         single_chip: Dict[tuple, float]) -> List[str]:
    """The BG-overtakes-CUDA observation (writeup.tex:19), re-derived:
    for each (DTYPE, OP), the smallest rank count whose collective
    aggregate rate exceeds the single-chip rate — if any measured rank
    count does. `coll_avgs` keys are (DTYPE, OP, ranks)."""
    by_pair: Dict[tuple, List[tuple]] = {}
    for (dt, op, ranks), gbps in sorted(coll_avgs.items()):
        by_pair.setdefault((dt, op), []).append((int(ranks), gbps))
    crossings: Dict[tuple, Optional[int]] = {}
    no_cross: List[str] = []
    for (dt, op), pts in sorted(by_pair.items()):
        sc = single_chip.get((dt, op))
        if not sc:
            continue
        pts.sort()
        over = next((r for r, g in pts if g > sc), None)
        if over is not None:
            crossings[(dt, op)] = over
        else:
            top_r, top_g = pts[-1]
            no_cross.append(
                f"{dt} {op}: no crossover up to {top_r} ranks "
                f"({top_g:.2f} vs {sc:.2f} GB/s single-chip).")
    lines: List[str] = []
    if crossings:
        tail = (" (the reference saw Blue Gene overtake its GPU near "
                "500-600 ranks, writeup.tex:19).")
        ranks_seen = set(crossings.values())
        if len(ranks_seen) == 1 and len(crossings) > 1:
            # every pair crosses at the same rank count: one line, not
            # one per pair
            lines.append(
                f"The mesh overtakes one chip at {ranks_seen.pop()} "
                f"ranks for every measured (dtype, op) pair" + tail)
        else:
            for (dt, op), over in sorted(crossings.items()):
                lines.append(f"{dt} {op}: the mesh overtakes one chip "
                             f"at {over} ranks" + tail)
    return lines + no_cross


def derive_findings(rows: Optional[Sequence[dict]] = None,
                    single_chip: Optional[Dict[tuple, float]] = None,
                    coll_avgs: Optional[Dict[tuple, float]] = None,
                    reference: Optional[Dict[tuple, float]] = None
                    ) -> List[str]:
    """All applicable findings for the data at hand (any subset).
    `rows` are shmoo rows, ideally roofline-annotated (bench.roofline):
    the half-power points need only (n, gbps); the cliff also needs each
    row's `regime` tag and yields nothing without it.
    The counterpart of tpu_reductions/bench/findings.py:194.
    """
    lines: List[str] = []
    if rows:
        lines += half_power_points(rows)
        lines += l2_cliff(rows)
        # rows the oracle never checked must not read as verified; the
        # caveat travels with the findings, so a report without the
        # roofline section (whose summarize flags it too) carries it
        unverified = [r for r in rows
                      if r.get("status") == "RECOVERED"
                      or r.get("verified") is False]
        if unverified:
            lines.append(
                f"CAVEAT: {len(unverified)} of {len(rows)} curve rows "
                "are timing-only recoveries (status RECOVERED — the "
                "oracle never ran on them); curve-derived findings "
                "above rest partly on unverified timings.")
    if single_chip and reference:
        lines += reference_multiples(single_chip, reference)
    if coll_avgs and single_chip:
        lines += collective_crossover(coll_avgs, single_chip)
    return lines
