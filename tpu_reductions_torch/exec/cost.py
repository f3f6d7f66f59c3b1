"""The cost oracle: kernel, topology, wire and scan picks learned from the
port's own evidence.

The counterpart of tpu_reductions/exec/cost.py. Each pick is a
`Decision`: the choice, the static default it replaces, every candidate
with its predicted seconds, and the artifacts it consulted; each can be
stamped into the ledger as an `exec.select` event.

The evidence is what the port's instruments write under `out/`, relative
to the root (`TPU_REDUCTIONS_EVIDENCE_ROOT`, else the working directory):

  autotune  `out/tune.json`           bench.autotune --out: ranked GB/s
                                      per kernel
  stream    `out/stream_probe.json`   bench.stream --serial-baseline
                                      --out: the final row's
                                      overlap_efficiency
  compile   `out/compile_ledger.json` bench.warm: per-surface cold/warm
                                      rows (a cold surface pays its
                                      compile_s)
  scaling   `out/rank_scaling/scaling_shape.json`
                                      bench.rank_scaling: the peak GB/s
                                      anchors the alpha-beta topology
                                      pricer's beta
  quant     `out/quant_curve.json`    bench.quant_curve: wire_reduction
                                      per bits
  family    `out/family_spot.json`    bench.family_spot --out: SCAN GB/s
                                      per implementation

A missing file drops out of the evidence and the pick falls back to the
static choice, as in JAX: the oracle reads JSON and touches no device.

The model constants are the H100's, those bench/roofline.py uses: 50 MiB
of L2 as the residency bound and 3.35 TB/s of HBM. The port has measured
no L2 rate, so the kernel axis prices a payload that fits in L2 from the
race's k6 rate alone, and falls back to the static pick when the race
holds no k6 row (the JAX oracle had v5e's VMEM rate as a second source).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

# byte widths per dtype name; bfloat16 moves 2 B an element
_ITEMSIZE = {"int": 4, "int32": 4, "float": 4, "float32": 4,
             "bfloat16": 2, "double": 8, "float64": 8}

# the H100's L2 (the residency bound) and HBM rate (bench/roofline.py)
_RESIDENT_BYTES = 50 << 20
_HBM_RATE = 3.35e12

# the SUM dtypes the quantized wire carries (collectives/quant.py)
_QUANT_SUM_DTYPES = ("float32", "bfloat16")

_EVIDENCE = {
    "autotune": os.path.join("out", "tune.json"),
    "stream": os.path.join("out", "stream_probe.json"),
    "compile": os.path.join("out", "compile_ledger.json"),
    "scaling": os.path.join("out", "rank_scaling", "scaling_shape.json"),
    "quant": os.path.join("out", "quant_curve.json"),
    "family": os.path.join("out", "family_spot.json"),
}


@dataclasses.dataclass(frozen=True)
class Decision:
    """One audited pick: the choice, the static default, every candidate
    with its predicted seconds, and the artifacts consulted (empty: the
    static fallback)."""

    axis: str                          # kernel|topology|wire|scan
    choice: str
    static_choice: str
    candidates: Tuple[Tuple[str, Optional[float]], ...]
    evidence: Tuple[str, ...]
    reason: str

    @property
    def flipped(self) -> bool:
        return self.choice != self.static_choice

    def row(self) -> Dict[str, Any]:
        """The JSON row of the decision table and the exec.select event."""
        return {
            "axis": self.axis,
            "choice": self.choice,
            "static": self.static_choice,
            "flipped": self.flipped,
            "candidates": [
                {"name": n,
                 "predicted_s": (round(s, 9) if s is not None else None)}
                for n, s in self.candidates],
            "evidence": list(self.evidence),
            "reason": self.reason,
        }


def emit_select(decision: Decision, **geometry) -> None:
    """Stamp one pick into the ledger as an `exec.select` event."""
    from tpu_reductions_torch.obs import ledger
    ledger.emit("exec.select", **decision.row(), **geometry)


class CostOracle:
    """Evidence-backed picks. Artifacts load lazily and are cached; a
    missing or unreadable one drops out of the evidence."""

    def __init__(self, root: Optional[str] = None) -> None:
        self.root = (root
                     or os.environ.get("TPU_REDUCTIONS_EVIDENCE_ROOT")
                     or ".")
        self._cache: Dict[str, Any] = {}

    def _load(self, key: str):
        if key not in self._cache:
            path = os.path.join(self.root, _EVIDENCE[key])
            try:
                with open(path) as f:
                    self._cache[key] = json.load(f)
            except (OSError, ValueError):
                self._cache[key] = None
        return self._cache[key]

    def _path(self, key: str) -> str:
        return _EVIDENCE[key]

    def kernel_rates(self) -> Optional[Dict[int, float]]:
        """The best PASSED GB/s per kernel id of the race (the comparator's
        rows have no kernel and are skipped)."""
        doc = self._load("autotune")
        if not doc or not doc.get("ranked"):
            return None
        rates: Dict[int, float] = {}
        for row in doc["ranked"]:
            if row.get("status") != "PASSED" or row.get("kernel") is None:
                continue
            kid = int(row["kernel"])
            rates[kid] = max(rates.get(kid, 0.0), float(row["gbps"]))
        return rates or None

    def stream_overlap(self) -> Optional[float]:
        """The stream probe's overlap_efficiency (serial wall over
        streamed wall)."""
        doc = self._load("stream")
        if not doc:
            return None
        for row in reversed(doc.get("rows") or []):
            if row.get("final") and row.get("status") == "PASSED":
                eff = row.get("overlap_efficiency")
                return float(eff) if eff else None
        return None

    def compile_penalty(self, surface: str) -> float:
        """The cold seconds a surface never seen warm pays; 0.0 when it
        was warm or there is no ledger."""
        doc = self._load("compile")
        if not doc:
            return 0.0
        cold_s, warm = 0.0, False
        for row in doc.get("surfaces") or []:
            if row.get("surface") != surface:
                continue
            if row.get("verdict") == "warm":
                warm = True
            elif row.get("verdict") == "cold":
                cold_s = max(cold_s, float(row.get("compile_s") or 0.0))
        return 0.0 if warm else cold_s

    def measured_beta(self) -> Optional[float]:
        """Seconds per wire byte at the peak GB/s of the rank sweep."""
        doc = self._load("scaling")
        if not doc or not doc.get("series"):
            return None
        peak = max((pt[1] for pts in doc["series"].values()
                    for pt in pts), default=0.0)
        return (1.0 / (peak * 1e9)) if peak > 0 else None

    def wire_reduction(self, bits: int) -> Optional[float]:
        """The median wire reduction of the quantized SUM ring at `bits`."""
        doc = self._load("quant")
        if not doc:
            return None
        vals = sorted(float(r["wire_reduction"])
                      for r in doc.get("rows") or []
                      if r.get("method") == "SUM"
                      and int(r.get("bits", 0)) == bits
                      and r.get("status") == "PASSED")
        return vals[len(vals) // 2] if vals else None

    def scan_rates(self, dtype: str) -> Optional[Dict[str, float]]:
        """The best PASSED GB/s per SCAN implementation for `dtype`."""
        doc = self._load("family")
        if not doc:
            return None
        rates: Dict[str, float] = {}
        for row in doc.get("rows") or []:
            if (row.get("method") != "SCAN"
                    or row.get("dtype") != dtype
                    or row.get("status") != "PASSED"):
                continue
            impl = str(row.get("impl"))
            rates[impl] = max(rates.get(impl, 0.0),
                              float(row.get("gbps") or 0.0))
        return rates or None

    # -- the four axes ---------------------------------------------------

    def pick_kernel(self, method: str, dtype: str, n: int) -> Decision:
        """k6 against k10 by payload regime; static default k6. Within
        the L2 residency bound k6 at the race's rate; past it both read
        HBM, and k10 gains the stream probe's overlap multiplier."""
        payload = n * _ITEMSIZE.get(dtype, 4)
        rates = self.kernel_rates()
        overlap = self.stream_overlap()
        if rates is None or overlap is None or not rates.get(6):
            return Decision(
                axis="kernel", choice="k6", static_choice="k6",
                candidates=(("k6", None), ("k10", None)), evidence=(),
                reason="no autotune/stream evidence; static kernel 6")
        k6_rate = rates[6] * 1e9
        resident = payload <= _RESIDENT_BYTES
        k6_s = payload / (k6_rate if resident else _HBM_RATE)
        k10_s = (payload / (_HBM_RATE * max(overlap, 1e-9))
                 + self.compile_penalty("k10@4"))
        evidence = [self._path("autotune"), self._path("stream")]
        if self._load("compile"):
            evidence.append(self._path("compile"))
        choice = "k6" if (resident or k6_s <= k10_s) else "k10"
        return Decision(
            axis="kernel", choice=choice, static_choice="k6",
            candidates=(("k6", k6_s), ("k10", k10_s)),
            evidence=tuple(evidence),
            reason=(f"payload {payload} B "
                    f"{'<=' if resident else '>'} L2 residency bound "
                    f"{_RESIDENT_BYTES} B"
                    + ("" if resident else
                       f"; stream overlap x{overlap:.2f}")))

    def pick_topology(self, k: int, per_rank_len: int,
                      elem_bytes: int = 4) -> Decision:
        """Ring family against the 2D torus by rank count, priced by the
        alpha-beta model of collectives/algorithms.py with beta from the
        rank sweep; static default ring."""
        beta = self.measured_beta()
        if beta is None:
            return Decision(
                axis="topology", choice="ring", static_choice="ring",
                candidates=(("ring", None), ("torus2d", None)),
                evidence=(),
                reason="no rank-scaling evidence; static ring family")
        from tpu_reductions_torch.collectives.algorithms import (
            _TOPOLOGY_LABELS, algorithm_cost, topology_supported)
        payload = per_rank_len * elem_bytes
        cands = []
        for topo in ("ring", "bidir", "torus2d"):
            if not topology_supported(topo, k, per_rank_len):
                continue
            cands.append((topo, algorithm_cost(
                _TOPOLOGY_LABELS[topo], k, payload, 20e-6, beta)))
        if not cands:
            cands = [("naive", algorithm_cost(
                _TOPOLOGY_LABELS["naive"], k, payload, 20e-6, beta))]
        choice = min(cands, key=lambda c: c[1])[0]
        return Decision(
            axis="topology", choice=choice, static_choice="ring",
            candidates=tuple(cands),
            evidence=(self._path("scaling"),),
            reason=(f"alpha-beta pick at k={k}, "
                    f"{payload} B/rank, learned beta="
                    f"{beta:.3e} s/B"))

    def pick_wire(self, method: str, dtype: str, k: int,
                  payload_bytes: int, slack_s: Optional[float], *,
                  est_s: Optional[float] = None, bits: int = 8,
                  slack_factor: float = 2.0) -> Decision:
        """Exact against quantized wire by deadline slack (the serving
        engine's rule: quantize when slack < slack_factor x the estimate
        and the pair is quantizable). `est_s` is the caller's estimate;
        without it the exact ring is priced by the alpha-beta model."""
        supported = (method.upper() == "SUM"
                     and dtype in _QUANT_SUM_DTYPES)
        quant_label = f"q{bits}"
        if est_s is None:
            from tpu_reductions_torch.collectives.algorithms import (
                algorithm_cost)
            est_s = algorithm_cost("ring_rs_ag", k, payload_bytes,
                                   20e-6, self.measured_beta()
                                   or 1 / 100e9)
        reduction = self.wire_reduction(bits)
        evidence = ((self._path("quant"),) if reduction else ())
        quant_s = (est_s / reduction) if reduction else None
        if not supported or slack_s is None:
            return Decision(
                axis="wire", choice="exact", static_choice="exact",
                candidates=(("exact", est_s), (quant_label, quant_s)),
                evidence=evidence,
                reason=("no deadline" if supported else
                        f"{method}/{dtype} not quantizable"))
        tight = slack_s < slack_factor * max(est_s, 1e-6)
        return Decision(
            axis="wire", choice=(quant_label if tight else "exact"),
            static_choice="exact",
            candidates=(("exact", est_s), (quant_label, quant_s)),
            evidence=evidence,
            reason=(f"slack {slack_s:.4f}s "
                    f"{'<' if tight else '>='} {slack_factor:g} x "
                    f"est {est_s:.4f}s"))

    def pick_scan(self, dtype: str, n: int) -> Decision:
        """xla-cumsum (torch.cumsum) against mxu-scan (the blocked
        product) for a SCAN launch; static default xla-cumsum. mxu-scan
        is float-only; both are priced as payload / family-spot rate plus
        any cold penalty their surface owes."""
        payload = n * _ITEMSIZE.get(dtype, 4)
        floating = dtype in ("float", "float32", "bfloat16",
                             "double", "float64")
        if not floating:
            return Decision(
                axis="scan", choice="xla-cumsum",
                static_choice="xla-cumsum",
                candidates=(("xla-cumsum", None),), evidence=(),
                reason=(f"mxu-scan is float-only; {dtype} rides the "
                        "XLA cumsum baseline"))
        rates = self.scan_rates(dtype)
        if (not rates or "mxu-scan" not in rates
                or "xla-cumsum" not in rates):
            return Decision(
                axis="scan", choice="xla-cumsum",
                static_choice="xla-cumsum",
                candidates=(("mxu-scan", None), ("xla-cumsum", None)),
                evidence=(),
                reason="no family_spot evidence; static xla-cumsum")
        cands = tuple(
            (impl, payload / (rates[impl] * 1e9)
             + self.compile_penalty(impl))
            for impl in ("mxu-scan", "xla-cumsum"))
        choice = min(cands, key=lambda c: c[1])[0]
        evidence = [self._path("family")]
        if self._load("compile"):
            evidence.append(self._path("compile"))
        return Decision(
            axis="scan", choice=choice, static_choice="xla-cumsum",
            candidates=cands, evidence=tuple(evidence),
            reason=(f"measured {rates['mxu-scan']:.3f} GB/s mxu-scan "
                    f"vs {rates['xla-cumsum']:.3f} GB/s xla-cumsum "
                    f"at {payload} B"))


def decisions_markdown(doc: dict) -> str:
    """The report.md section of an exec_decisions.json (bench/regen.py
    folds it): every pick against its static default. Empty without
    rows."""
    rows = doc.get("rows") or []
    if not rows:
        return ""
    lines = ["## execution-core decision audit (learned cost oracle)",
             "",
             "Cost-oracle picks over the decision grid vs the static "
             "defaults (`python -m tpu_reductions_torch.exec --explain`). "
             "A YES row is a regime flip: the port's evidence moved the "
             "pick off the static choice.",
             "",
             "| axis | geometry | chosen | static | flipped | why |",
             "|---|---|---|---|---|---|"]
    flips = 0
    for r in rows:
        geom = r.get("geometry") or {}
        gtxt = " ".join(f"{k}={v}" for k, v in geom.items()) or "-"
        flipped = bool(r.get("flipped",
                             r.get("choice") != r.get("static")))
        flips += flipped
        lines.append(f"| {r.get('axis')} | {gtxt} | {r.get('choice')} "
                     f"| {r.get('static')} "
                     f"| {'YES' if flipped else 'no'} "
                     f"| {r.get('reason') or '-'} |")
    lines.append("")
    lines.append(f"{len(rows)} decision(s), {flips} regime flip(s) vs "
                 "the static baseline.")
    return "\n".join(lines)
