"""Roofline accounting of bandwidth rows, with the card's memory model.

The port's copy of tpu_reductions/bench/roofline.py:1. The reference judged
its kernel against its GPU's memory bandwidth (about 90% of it at
n = 2^24, reduction_kernel.cu:74-127 against mpi/CUdata.txt); this module
does the same for shmoo rows, mechanically, so a generated report never
ships curves without the analysis.

Two regimes. A chained working set at or below the card's L2 (50 MiB on
the H100) can stay in it between the chain's calls and read faster than
HBM: such a row is tagged `l2_resident` and is given no HBM fraction.
Every larger one is `hbm_bound`, and its fraction of the HBM roof is the
kernel-quality number.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from tpu_reductions_torch.bench.findings import pow2_label

# Per device kind (torch.cuda.get_device_name()): the HBM roof in B/s, the
# H100 SXM data sheet's rate at 700 W (the roof chip_smoke.py and
# ops/chain.py use), and the L2 size that bounds an on-chip working set.
# An unknown kind gets the H100's model, labelled with its own kind, so a
# misidentified card stays auditable.
MEMORY_MODEL = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "l2_bytes": 50 << 20},
}
_DEFAULT_KIND = "NVIDIA H100 80GB HBM3"
_ITEMSIZE = {"int32": 4, "float32": 4, "float64": 8, "bfloat16": 2}


def _model(kind: str) -> dict:
    return next((m for k, m in MEMORY_MODEL.items() if kind.startswith(k)),
                MEMORY_MODEL[_DEFAULT_KIND])


def annotate(shmoo_rows: Sequence[dict],
             device_kind: Optional[str] = None) -> List[dict]:
    """Each shmoo row (BenchResult.to_dict()) with its working set, its
    regime and, when HBM-bound, its fraction of the HBM roof.
    The counterpart of tpu_reductions/bench/roofline.py:41."""
    kind = device_kind or _DEFAULT_KIND
    model = _model(kind)
    out = []
    for r in shmoo_rows:
        bytes_ = r["n"] * _ITEMSIZE[r["dtype"]]
        regime = ("l2_resident" if bytes_ <= model["l2_bytes"]
                  else "hbm_bound")
        row = dict(r, working_set_bytes=bytes_, regime=regime,
                   device_kind=kind)
        if regime == "hbm_bound":
            row["hbm_fraction"] = (r["gbps"] * 1e9
                                   / model["hbm_bytes_per_s"])
        out.append(row)
    return out


def summarize(annotated: Sequence[dict]) -> List[str]:
    """Roofline lines for the report: per (dtype, method), the best
    HBM-bound fraction and the L2-resident peak.
    The counterpart of tpu_reductions/bench/roofline.py:65."""
    lines: List[str] = []
    keys = sorted({(r["dtype"], r["method"]) for r in annotated})
    if annotated:
        kind = annotated[0]["device_kind"]
        model = _model(kind)
        lines.append(f"Device: {kind}; HBM roof "
                     f"{model['hbm_bytes_per_s'] / 1e9:.0f} GB/s; "
                     f"L2-residency bound "
                     f"{model['l2_bytes'] >> 20} MiB.")
    for dtype, method in keys:
        rows = [r for r in annotated
                if (r["dtype"], r["method"]) == (dtype, method)]
        hbm = [r for r in rows if r["regime"] == "hbm_bound"]
        l2 = [r for r in rows if r["regime"] == "l2_resident"]
        if hbm:
            best = max(hbm, key=lambda r: r.get("hbm_fraction", 0.0))
            lines.append(
                f"{dtype} {method}: HBM-bound peak {best['gbps']:.1f} "
                f"GB/s = {100 * best['hbm_fraction']:.0f}% of the roof "
                f"(n={pow2_label(best['n'])})")
        if l2:
            best_l2 = max(l2, key=lambda r: r["gbps"])
            lines.append(
                f"{dtype} {method}: L2-resident peak "
                f"{best_l2['gbps']:.1f} GB/s "
                f"(n={pow2_label(best_l2['n'])}; the working set fits the "
                "L2, so no HBM fraction is given)")
    # rows the oracle never checked must not read as verified
    unverified = [r for r in annotated
                  if r.get("verified") is False
                  or r.get("status") == "RECOVERED"]
    if unverified:
        lines.append(
            f"CAVEAT: {len(unverified)} of {len(annotated)} rows above "
            "are timing-only (status RECOVERED — the run died before "
            "the oracle-verification phase); verified rows carry "
            "status PASSED in the raw data.")
    return lines
