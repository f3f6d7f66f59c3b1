"""Critical-path attribution over the reconstructed span tree.

The counterpart of tpu_reductions/obs/critical_path.py. The spans of a
ledger (obs/trace_export.build_spans) are swept along the timeline; at
every instant the deepest open span holds the wall clock, its ancestors
only wait on it. Merging adjacent instants with the same answer gives
the longest dependent chain, and bucketing each segment by its span's
leading dotted token (compile, staging, chain, collective, serve,
stream, ...) gives the shares the window summary prints:

    window bounded by: compile 38% -> staging 22% -> chain 31%

A sequential-chain model: one process drives the card at a time, so the
deepest active span is the bottleneck. Time with no span open is `idle`.
Offline: stdlib only, no device. sched/priors.py reads the per-span
medians (`span_medians`).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from tpu_reductions_torch.obs.trace_export import build_spans

# spans too coarse to be a bottleneck label — their CHILDREN hold the
# clock; only when nothing finer is open do they win a segment
_ENVELOPES = ("session", "request")


def _label(name: str) -> str:
    """Bucket a span name by its leading dotted token ("compile.start"
    sliced to "compile"); synthesized request spans -> "serve"."""
    tok = name.split(".")[0].split(" ")[0]
    return "serve" if tok == "request" else tok


def compute(events: List[dict], min_share: float = 0.01) -> Optional[dict]:
    """Critical path for one parsed ledger. Returns None when there is
    nothing to attribute, else {"wall_s", "segments": [{label, dur_s,
    share}], "shares": {label: share}, "chain": "a NN% -> b NN%"}
    with one segment per label (total seconds that label held the
    path), ordered by first appearance, shares over the whole wall
    clock, sub-`min_share` labels folded away."""
    spans = [s for s in build_spans(events) if s["t1"] > s["t0"]]
    if not spans:
        return None
    t0 = min(s["t0"] for s in spans)
    t1 = max(s["t1"] for s in spans)
    wall = t1 - t0
    if wall <= 0:
        return None
    # depth = how nested the span is at each instant; deepest wins,
    # envelope spans lose ties to anything more specific
    cuts = sorted({s["t0"] for s in spans} | {s["t1"] for s in spans})
    timeline: List[List] = []   # [label, dur]
    for a, b in zip(cuts, cuts[1:]):
        if b <= a:
            continue
        active = [s for s in spans if s["t0"] <= a and s["t1"] >= b]
        if not active:
            label = "idle"
        else:
            def _depth(s):
                return (sum(1 for o in active
                            if o["t0"] <= s["t0"] and o["t1"] >= s["t1"]
                            and o is not s),
                        _label(s["name"]) not in _ENVELOPES,
                        -(s["t1"] - s["t0"]))
            label = _label(max(active, key=_depth)["name"])
            if label in _ENVELOPES:
                label = "idle"
        if timeline and timeline[-1][0] == label:
            timeline[-1][1] += b - a
        else:
            timeline.append([label, b - a])
    # aggregate per label, ordered by FIRST appearance on the critical
    # path: a window with 200 alternating chain-trip/idle slivers reads
    # as "idle NN% -> chain NN%", not a 200-link chain — the headline
    # is where the wall clock went, in the order the window spent it
    shares: Dict[str, float] = {}
    order: List[str] = []
    for label, dur in timeline:
        if label not in shares:
            order.append(label)
        shares[label] = shares.get(label, 0.0) + dur / wall
    segments = [{"label": label, "dur_s": round(shares[label] * wall, 6),
                 "share": round(shares[label], 4)}
                for label in order if shares[label] >= min_share]
    if not segments:
        return None
    chain = " -> ".join(f"{s['label']} {s['share'] * 100:.0f}%"
                        for s in segments)
    return {"wall_s": round(wall, 6), "segments": segments,
            "shares": {k: round(v, 4) for k, v in sorted(
                shares.items(), key=lambda kv: -kv[1])},
            "chain": chain}


def span_medians(events: List[dict]) -> Dict[str, float]:
    """Median duration per span name across one ledger — the sub-task
    evidence sched/priors.py folds into its duration model (a task
    whose compile span is warm-cached shrinks by the compile
    median)."""
    import statistics
    by_name: Dict[str, List[float]] = {}
    for s in build_spans(events):
        if s["dur_s"] > 0 and not s["cut"]:
            by_name.setdefault(s["name"], []).append(s["dur_s"])
    return {name: round(statistics.median(v), 6)
            for name, v in sorted(by_name.items())}


def markdown(cp: Optional[dict]) -> List[str]:
    """The WINDOW_SUMMARY.md critical-path section (timeline
    --summary-md appends it; the session exit trap commits it)."""
    if not cp:
        return []
    lines = ["### critical path", "",
             f"window bounded by: {cp['chain']}", "",
             "| segment | wall s | share |", "| --- | --- | --- |"]
    for s in cp["segments"]:
        lines.append(f"| {s['label']} | {s['dur_s']:.3f} | "
                     f"{s['share'] * 100:.1f}% |")
    lines.append("")
    return lines
