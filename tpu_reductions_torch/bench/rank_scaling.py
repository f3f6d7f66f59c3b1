"""The rank-scaling experiment: bandwidth against the rank count.

The counterpart of the JAX package's scripts/run_rank_scaling.sh, as a
module:

    python -m tpu_reductions_torch.bench.rank_scaling OUT
        [--max-ranks=1024] [--ranks=2,8,64,256,1024] [--n=1048576]
        [--retries=3] [--curve-n=1048576] [--rows=256] [--dryrun]
        [--cards=C]

In order, into OUT:
  1. `sweep_collective` over the rank ladder (the doubling ladder up to
     --max-ranks, or --ranks), int32 and float64 x MAX/MIN/SUM, timed
     per iteration as in the JAX package's script, with
     `raw_output/` and the resumable `collective_sweep.json`;
  2. `aggregate.pipeline` (collected.txt, results/*.txt) and the
     averages;
  3. `plot_vs_ranks` per dtype, and `plot_scaling_shape` against the
     reference's published 64/256/1024 rows (mpi/results/*_SUM.txt);
  4. the amortisation probe: int32 SUM at the top rung over n = 2^20,
     2^22, 2^24;
  5. `scaling_shape.json`;
  6. the quantized curve (bench/quant_curve.py) into quant_curve.json;
  7. the reshard curve (bench/reshard_curve.py) into reshard_curve.json;
     both curves over ranks 2..64 (or `curve_ranks`), capped at the
     sweep's top rung.

The whole experiment runs across `cards` (--cards; default every card
of the host, as the JAX mesh takes every device): one process a card,
spawned once (bench/multicard.run_ladder, its control files under
OUT/ladder), NCCL between the cards, each rung's k ranks on min(k, C)
cards in contiguous blocks (parallel/mesh.placement), so a hop between
ranks of two cards crosses NVLink and a hop between ranks of one card is
a copy inside it; rank 0 alone writes OUT's files, and each sweep row
carries its busbw a card against NVLink's 450 GB/s. With --cards=1 (or
one card) every rank is a row of one tensor (parallel/mesh.py): a
collective's GB/s is a rate of copies inside one card's memory, not of
links. The JSON's note and the series labels say which. The reference's
torus rows are plotted as a shape (each curve over its own smallest
rung), never as absolute rates beside ours. --dryrun rehearses the whole
run on the CPU with one retry (--cards=C there: C gloo processes);
without --dryrun and without a card it raises.

Its steps: scripts/run_rank_scaling.sh:1-129.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Optional, Sequence

from tpu_reductions_torch.utils.logging import BenchLogger

# the reference's published rank rows (mpi/results/INT_SUM.txt and
# DOUBLE_SUM.txt, GB/s on the Blue Gene/L torus), for the shape figure
REFERENCE_ROWS = {"INT SUM": [(64, 9.182), (256, 38.6484),
                              (1024, 146.818)],
                  "DOUBLE SUM": [(64, 3.8102), (256, 15.3126),
                                 (1024, 60.9754)]}
LADDER = (2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
PROBE_NS = (1 << 20, 1 << 22, 1 << 24)
CURVE_RANKS = (2, 4, 8, 16, 32, 64)


def placement(ranks: Sequence[int], cards: int) -> dict:
    """rung -> the ranks each card holds (device.rank_blocks: min(k, C)
    cards in contiguous blocks).
    No reference analog: the JAX mesh puts a rank on each device."""
    from tpu_reductions_torch.device import rank_blocks
    return {int(k): [len(b) for b in rank_blocks(k, cards)] for k in ranks}


def _where(platform: str, cards: int) -> str:
    """The series labels' placement words."""
    if cards == 1:
        return f"ranks as rows on {platform}"
    return f"ranks on {cards} {'cards' if platform == 'gpu' else 'processes'}"


def _note(platform: str, cards: int = 1,
          blocks: Optional[dict] = None) -> str:
    if cards > 1:
        spread = "; ".join(f"{k} ranks: {', '.join(map(str, b))}"
                           for k, b in (blocks or {}).items())
        if platform == "cpu":
            return (f"each rung's k ranks lie on min(k, {cards}) processes "
                    f"of the host CPU over gloo, one process a card's "
                    f"stand-in, in contiguous blocks (ranks a process: "
                    f"{spread}); absolute GB/s are host copy rates; the "
                    f"curve's shape (aggregate bandwidth vs ranks) is the "
                    f"product")
        return (f"each rung's k ranks lie on min(k, {cards}) cards, one "
                f"process a card, in contiguous blocks (ranks a card: "
                f"{spread}); a hop between ranks of two cards crosses "
                f"NVLink through NCCL and a hop between ranks of one card "
                f"is a copy inside its memory, so a rung's GB/s mix link "
                f"and copy rates; each row carries its busbw a card "
                f"against NVLink's 450 GB/s each way; the curve's shape "
                f"(aggregate bandwidth vs ranks) is the product, compared "
                f"with the reference's torus rows only as a shape")
    if platform == "cpu":
        return ("the ranks are rows of one tensor on the host CPU; "
                "absolute GB/s are host copy rates; the curve's shape "
                "(aggregate bandwidth vs ranks) is the product")
    return ("the ranks are rows of one tensor on one card: every hop is "
            "a copy inside that card's memory, not a link, so GB/s are "
            "copy-and-combine rates of its memory; the curve's shape "
            "(aggregate bandwidth vs ranks) is the product, compared "
            "with the reference's torus rows only as a shape")


def run_rank_scaling(out_dir: str | Path, *, ranks: Sequence[int],
                     n: int = 1 << 20, retries: int = 3,
                     curve_n: int = 1 << 20, rows: int = 256,
                     platform: str = "gpu",
                     logger: Optional[BenchLogger] = None,
                     cards: Optional[int] = None, witness=None,
                     curve_ranks: Optional[Sequence[int]] = None) -> dict:
    """The experiment (module docstring). Returns {"shape": the
    scaling_shape.json object, "figures": paths, "quant": quant curve
    rows, "reshard": reshard curve rows, "sweep": sweep rows,
    "probe_dropped": the probe's n with no PASSED retry, "seconds": each
    stage's host seconds}: rank 0's across cards (`cards`, module
    docstring), where `witness` (bench/multicard.Witness) records every
    row's output for the one-card twin.
    The counterpart of scripts/run_rank_scaling.sh:22-129."""
    from tpu_reductions_torch.bench import multicard
    log = logger or BenchLogger(None, None)
    cards = multicard.host_cards(platform, cards)
    if multicard.spawns(cards):
        return multicard.run_ladder(
            "tpu_reductions_torch.bench.rank_scaling:run_rank_scaling",
            dict(out_dir=str(out_dir), ranks=list(ranks), n=n,
                 retries=retries, curve_n=curve_n, rows=rows,
                 platform=platform, cards=cards,
                 curve_ranks=(list(curve_ranks) if curve_ranks
                              else None)), cards,
            platform=platform, work_dir=Path(out_dir) / "ladder",
            logger=log,
            evidence=witness.root if witness is not None else None)
    from tpu_reductions_torch.bench import quant_curve, reshard_curve
    from tpu_reductions_torch.bench.aggregate import (average, collect,
                                                      pipeline)
    from tpu_reductions_torch.bench.collective_driver import \
        run_collective_benchmark
    from tpu_reductions_torch.bench.plot import (plot_scaling_shape,
                                                 plot_vs_ranks)
    from tpu_reductions_torch.bench.sweep import sweep_collective
    from tpu_reductions_torch.config import CollectiveConfig
    from tpu_reductions_torch.utils.jsonio import atomic_json_dump

    out = Path(out_dir)
    writer = multicard.reporting()
    if writer:
        out.mkdir(parents=True, exist_ok=True)
    ranks = list(ranks)
    blocks = placement(ranks, cards)
    seconds = {}
    t0 = time.perf_counter()

    def stage(name: str) -> None:
        # host seconds of each stage, set-up and verification included
        nonlocal t0
        now = time.perf_counter()
        seconds[name] = round(now - t0, 3)
        log.log(f"stage {name}: {seconds[name]} s")
        t0 = now

    log.log(f"rank-scaling sweep over {ranks} ranks on {platform}"
            + (f", across {cards} cards (ranks a card: "
               f"{json.dumps(blocks)})" if cards > 1 else ""))
    # 1. the rank sweep, in the reference's op order (MAX, MIN, SUM)
    sweep = sweep_collective(rank_counts=ranks, n=n, retries=retries,
                             timing="periter", platform=platform,
                             out_dir=str(out), logger=log, cards=cards,
                             witness=witness)
    stage("sweep")
    figures, avgs = [], {}
    if writer:
        # 2. the averages
        pipeline(out / "raw_output", out)
        avgs = average(collect(out / "raw_output"))
        # 3. the figures
        for dt in sorted({key[0] for key in avgs}):
            figures += plot_vs_ranks(avgs, dt, out / dt.lower())
        shape_series = {}
        for op_dt, ref_rows in REFERENCE_ROWS.items():
            dt, op = op_dt.split()
            pts = [(k, g) for (d, o, k), g in sorted(avgs.items())
                   if d == dt and o == op]
            if pts:
                shape_series[f"{op_dt} (this port, "
                             f"{_where(platform, cards)})"] = pts
            shape_series[f"{op_dt} (reference torus)"] = ref_rows
        figures += plot_scaling_shape(shape_series, out / "scaling_shape")
    stage("averages_and_figures")
    # 4. the amortisation probe at the top rung: a droop that is fixed
    # per-call overhead recovers with the payload; what stays is the
    # per-rank cost of the algorithm
    top = max(ranks)
    probe, dropped = [], []
    for pn in PROBE_NS:
        res = run_collective_benchmark(
            CollectiveConfig(method="SUM", dtype="int32", n=pn,
                             retries=retries, num_devices=top,
                             timing="periter", platform=platform),
            logger=log,
            on_result=witness.keep if witness is not None else None)
        if witness is not None:
            witness.collective("probe", (top, pn), res)
        gb = [r.reference_gbps for r in res if r.status.name == "PASSED"]
        if gb:
            probe.append([pn, round(sum(gb) / len(gb), 3)])
        else:
            dropped.append(pn)
            log.log(f"amortisation probe n={pn}: no retry PASSED "
                    f"({[r.status.name for r in res]}); rung dropped")
    stage("probe")
    # 5. the shape verdict's data
    series = {}
    for (dt, op, k), g in sorted(avgs.items()):
        series.setdefault(f"{dt} {op}", []).append((k, round(g, 3)))
    shape = {"ranks": ranks, "series": series,
             "amortization_probe_ranks": top,
             "amortization_probe": probe,
             "reference_rows": {key: [list(p) for p in v]
                                for key, v in REFERENCE_ROWS.items()},
             "platform": platform, "n": n, "timing": "periter",
             "note": _note(platform, cards, blocks)}
    if cards > 1:
        shape.update(cards=cards, ranks_a_card=blocks)
    if writer:
        atomic_json_dump(out / "scaling_shape.json", shape)
        log.log("figures: " + ", ".join(str(f) for f in figures))
        log.log(f"wrote {out / 'scaling_shape.json'}")
    # 6. and 7. the two rank-axis curves, beside the rank evidence
    curve_ranks = [k for k in (curve_ranks or CURVE_RANKS) if k <= top]
    quant = quant_curve.run_curve(n=curve_n, seed=0, ranks=curve_ranks,
                                  out=str(out / "quant_curve.json"),
                                  platform=platform, logger=log,
                                  witness=witness)
    stage("quant_curve")
    reshard = reshard_curve.run_curve(n=curve_n, rows=rows, seed=0,
                                      ranks=curve_ranks,
                                      out=str(out / "reshard_curve.json"),
                                      platform=platform, logger=log,
                                      witness=witness)
    stage("reshard_curve")
    return {"shape": shape, "figures": figures, "quant": quant,
            "reshard": reshard, "sweep": sweep, "probe_dropped": dropped,
            "seconds": seconds}


def build_parser() -> argparse.ArgumentParser:
    """The CLI's parser: the knobs of scripts/run_rank_scaling.sh:15 (its
    usage line) as flags."""
    p = argparse.ArgumentParser(
        prog="tpu_reductions_torch.bench.rank_scaling",
        description="The rank-scaling experiment: the collective sweep "
                    "over the rank ladder, its averages and figures, the "
                    "amortisation probe, the quantized curve and the "
                    "reshard curve")
    p.add_argument("out_dir")
    p.add_argument("--max-ranks", type=int, default=1024,
                   help="top of the doubling ladder 2, 4, ..., 1024")
    p.add_argument("--ranks", type=str, default=None,
                   help="comma-separated rank ladder in place of the "
                        "doubling one")
    p.add_argument("--n", type=int, default=1 << 20,
                   help="elements a collective of the sweep reduces")
    p.add_argument("--retries", type=int, default=3)
    p.add_argument("--curve-n", type=int, default=1 << 20,
                   help="elements of the quantized and reshard curves "
                        "(over ranks 2..64, up to the sweep's top rung)")
    p.add_argument("--rows", type=int, default=256,
                   help="dim-0 extent of the reshard curve's payload")
    p.add_argument("--dryrun", action="store_true",
                   help="rehearse on the CPU, one retry a cell")
    p.add_argument("--cards", type=int, default=None,
                   help="processes, one a card, that each rung's ranks "
                        "lie on (min(k, C) of them; NCCL between the "
                        "cards, gloo with --dryrun); default every card "
                        "of the host, one process with --dryrun")
    return p


def _ints(p, flag: str, text: str) -> tuple:
    try:
        vals = tuple(int(v) for v in text.split(",") if v.strip())
    except ValueError:
        p.error(f"{flag} must be comma-separated ints, got {text!r}")
    if not vals or any(v < 2 for v in vals):
        p.error(f"{flag} must all be >= 2, got {text!r}")
    return vals


def main(argv=None) -> int:
    """CLI: exit 0 when every sweep row and curve cell PASSED (a WAIVED
    sweep row allowed) and every probe rung had a PASSED retry, 1
    otherwise, 2 on a usage error.
    The counterpart of scripts/run_rank_scaling.sh:15."""
    p = build_parser()
    ns = p.parse_args(argv)
    if ns.ranks:
        ranks = _ints(p, "--ranks", ns.ranks)
    else:
        ranks = tuple(k for k in LADDER if k <= ns.max_ranks)
        if not ranks:
            p.error(f"--max-ranks={ns.max_ranks} leaves no rung >= 2")
    if ns.cards is not None and ns.cards < 1:
        p.error(f"--cards must be >= 1, got {ns.cards}")
    platform = "cpu" if ns.dryrun else "gpu"
    from tpu_reductions_torch.bench.multicard import (LadderFailed,
                                                      host_cards)
    from tpu_reductions_torch.exec.core import maybe_arm
    try:
        host_cards(platform, ns.cards)
    except (RuntimeError, ValueError) as e:
        # cards this host cannot give: refused with the reason, no rung
        print(f"error: {e}", file=sys.stderr)
        return 1
    maybe_arm(platform)
    try:
        res = run_rank_scaling(
            ns.out_dir, ranks=ranks, n=ns.n,
            retries=1 if ns.dryrun else ns.retries, curve_n=ns.curve_n,
            rows=ns.rows, platform=platform, cards=ns.cards,
            logger=BenchLogger(None, None, console=sys.stdout))
    except LadderFailed as e:
        # a worker that died fails the ladder with its exit code
        print(f"error: {e}", file=sys.stderr)
        return e.code
    bad = ([r for r in res["sweep"]
            if r["status"] not in ("PASSED", "WAIVED")]
           + [r for r in res["quant"] + res["reshard"]
              if r["status"] != "PASSED"]
           + [{"probe_n": pn, "status": "dropped"}
              for pn in res["probe_dropped"]])
    for r in bad:
        print(f"not PASSED: {json.dumps(r, default=str)[:200]}",
              file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
