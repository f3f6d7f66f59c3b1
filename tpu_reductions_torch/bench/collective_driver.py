"""The cross-rank collective reduction benchmark: the mpi/reduce.c analog.

The counterpart of tpu_reductions/bench/collective_driver.py:1, over the
port's rank axis (parallel/mesh.py). Per-run flow, as reduce.c:9-108:

  the mesh (MPI_Init/Comm_size, :32-34): k ranks, the rows of one tensor
  -> per-rank payload, rank-offset seeded (:38-57)
  -> one warm-up collective (:61-64)
  -> `retries` timed collectives, periter or chained (:71-97)
  -> header + `DATATYPE OP NODES GB/sec` rows from rank 0 (:67-69,81,95)

Every result is verified against an elementwise host oracle (the
reference's MPI side had none). float64 runs natively by default, or as
the JAX package's pair planes (`--f64=dd`, or TPU_REDUCTIONS_FORCE_DD=1):
the dd ring for SUM, the exact key-pair collective for MIN/MAX.
`--quantized` runs the block-quantized wire (collectives/quant.py): the
SUM rings over float32/bfloat16 and the dd planes, held to their declared
error bound, and the exact coarse-key MIN/MAX; float64 under
`--quantized` always rides the dd planes, as in the JAX package.

In one process every rank is a row of one tensor on one card, so a hop
is a copy inside the card: a row's GB/s is a copy-and-combine rate
inside device memory and its busbw the registry's wire factor applied to
that time; neither is a link rate. With --num-processes=P each process
drives a card of its own (device.own_card) and holds a contiguous block
of the --devices ranks as rows on it (parallel/mesh.placement: --devices
= 6 on 4 cards is 1, 2, 1, 2; --devices = 2 uses the first two cards and
leaves the others idle); the processes join over NCCL, so a hop between
ranks of two cards crosses NVLink, while a hop between ranks of one card
stays a copy inside it, and each row then states its busbw a card
against NVLink's 450 GB/s each way (NVLINK_GBPS). On the CPU the
processes join over gloo. Each run says which in a `note:` line before
its header. Rank 0 reports (reduce.c:68,81,95); across processes a
periter repeat starts after a barrier, untimed, so that it times the
collective and not the skew each process's verification leaves.

CLI:
    python -m tpu_reductions_torch.bench.collective_driver --method=SUM
        [--type=int] [--n=N] [--devices=K] [--rooted[=scatter|root]]
        [--timing=periter|chained] [--f64=native|dd] [--platform=cpu]
        [--quantized [--quant-bits=4|8|16]]
        [--coordinator=HOST:PORT --num-processes=P --process-id=I]
        [--out=ARTIFACT.json]

Exit codes: 0 PASSED (WAIVED rows allowed), 1 FAILED, a parse or
validation error included.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
from typing import List, Optional

import numpy as np
import torch

from tpu_reductions_torch import device as device_mod
from tpu_reductions_torch.config import CollectiveConfig
from tpu_reductions_torch.faults.inject import fault_point
from tpu_reductions_torch.obs import ledger, trace
from tpu_reductions_torch.utils.logging import (COLLECTIVE_HEADER,
                                                BenchLogger, collective_row)
from tpu_reductions_torch.utils.qa import QAStatus
from tpu_reductions_torch.utils.rng import host_data
from tpu_reductions_torch.utils.timing import Stopwatch

NAME = "tpu_reductions_torch.collective"


@dataclasses.dataclass
class CollectiveResult:
    """One collective benchmark outcome: the data behind a rank-0
    `DATATYPE OP NODES GB/sec` row plus the QA status. The JAX package's
    fields and `to_dict` keys.
    The counterpart of tpu_reductions/bench/collective_driver.py:39."""

    method: str
    dtype: str
    n: int
    ranks: int
    repeat: int
    rooted: str                      # none|scatter|root (requested mode)
    time_s: float
    reference_gbps: float
    busbw_gbps: float
    status: QAStatus
    algorithm: str = "all_reduce"    # the wire pattern that ran
    # the port's, only where the mesh spans processes: the processes
    # (cards) holding its ranks, and on the card busbw a card over
    # NVLink's rate (link_share); to_dict leaves them out otherwise
    cards: Optional[int] = None
    nvlink_share: Optional[float] = None

    @property
    def passed(self) -> bool:
        """Status == PASSED; the counterpart of
        tpu_reductions/bench/collective_driver.py:58."""
        return self.status == QAStatus.PASSED

    def to_dict(self) -> dict:
        """JSON-ready row; status spelled as its QA marker name.
        The counterpart of tpu_reductions/bench/collective_driver.py:62."""
        d = dataclasses.asdict(self)
        d["status"] = self.status.name
        for key in ("cards", "nvlink_share"):
            if d[key] is None:
                del d[key]
        if self.cards:
            d["busbw_per_card_gbps"] = self.busbw_gbps / self.cards
        return d


def _build_payload(cfg: CollectiveConfig, k: int) -> torch.Tensor:
    """The global (k*L,) payload on the host: per-rank MT19937 streams
    with rank-offset seeds (reduce.c:38-41), each rank's the JAX
    package's bits (utils/rng.host_data), concatenated."""
    per_rank = cfg.n // k
    if per_rank == 0:
        raise ValueError(f"n={cfg.n} too small for {k} ranks")
    return torch.cat([host_data(per_rank, cfg.dtype, rank=r, seed=cfg.seed)
                      for r in range(k)])


def collective_meta(cfg: CollectiveConfig) -> dict:
    """The resume contract of one invocation (bench/resume.Checkpoint
    meta): prior rows are reused only when every key round-trips.
    The counterpart of tpu_reductions/bench/collective_driver.py:93."""
    return {"method": cfg.method, "dtype": cfg.dtype, "n": cfg.n,
            "retries": cfg.retries, "devices": cfg.num_devices,
            "rooted": cfg.rooted, "mode": cfg.mode,
            "mapping": cfg.mapping, "timing": cfg.timing,
            "chain_span": cfg.chain_span, "quantized": cfg.quantized,
            "quant_bits": cfg.quant_bits, "seed": cfg.seed,
            "platform": cfg.platform, "f64": cfg.f64}


def _result_from_collective_row(row: dict) -> CollectiveResult:
    """A CollectiveResult from a persisted artifact row, so that resumed
    rows flow through the same exit-status paths as fresh ones."""
    return CollectiveResult(
        row["method"], row["dtype"], row["n"], row["ranks"],
        row["repeat"], row.get("rooted", "none"),
        row.get("time_s", 0.0), row.get("reference_gbps", 0.0),
        row.get("busbw_gbps", 0.0),
        QAStatus[row.get("status", "FAILED")],
        row.get("algorithm", "all_reduce"), row.get("cards"),
        row.get("nvlink_share"))


def _resume_rows(cfg: CollectiveConfig, checkpoint, row_key,
                 logger: BenchLogger) -> Optional[List[CollectiveResult]]:
    """Reuse an interrupted run's full row set for this config (every
    repeat present and reusable), printing its rows again; None means
    measure afresh. Whole-config grain: a chained run times all reps in
    one slope call."""
    key = row_key or (lambda rep: rep)
    prior = [checkpoint.resume(key(rep)) for rep in range(cfg.retries)]
    if not prior or not all(r is not None for r in prior):
        return None
    logger.log(COLLECTIVE_HEADER)
    results = []
    for row in prior:
        checkpoint.add(row)
        gbps = row.get("reference_gbps")
        if row.get("status") == "PASSED" and gbps:
            logger.log(collective_row(row["dtype"], row["method"],
                                      row["ranks"], gbps))
        results.append(_result_from_collective_row(row))
    logger.log(f"note: {len(prior)} row(s) resumed from prior artifact "
               "(interrupted run; rows reused, not re-measured)")
    return results


def run_collective_benchmark(cfg: CollectiveConfig,
                             logger: Optional[BenchLogger] = None,
                             checkpoint=None, row_key=None,
                             on_result=None,
                             timings=None) -> List[CollectiveResult]:
    """Run `retries` collectives on one (method, dtype, rank count) mesh:
    one reduce.c process run (its warm-up and timed loop, reduce.c:61-96).

    `checkpoint` (bench/resume.Checkpoint) persists each row as it lands,
    and when an interrupted artifact already holds this config's full
    row set, reuses it without touching the device (`row_key(rep)` maps a
    repeat to its checkpoint key; default the repeat itself).
    `on_result(out, coll, chain)`, when given, sees the verified output
    of the last collective, the collective, and the timed chain's scalar
    on the host (None without chained timing; bench/multicard.py compares
    them across placements). `timings`, a sequence of "periter" and
    "chained", times the one payload, warm-up and oracle each way in
    turn in place of cfg.timing, `retries` rows each, in that order
    (bench/multicard.py; not with a checkpoint, whose rows are keyed by
    repeat)."""
    logger = logger or BenchLogger(None, None)
    if checkpoint is not None:
        if timings is not None:
            raise ValueError("timings= runs without a checkpoint")
        reused = _resume_rows(cfg, checkpoint, row_key, logger)
        if reused is not None:
            return reused
    return _run_collective_benchmark(cfg, logger, checkpoint=checkpoint,
                                     row_key=row_key, on_result=on_result,
                                     timings=tuple(timings or (cfg.timing,)))


def _use_dd_planes(cfg: CollectiveConfig) -> bool:
    """Whether float64 travels as two 32-bit planes (the JAX
    `_dd_planes_for`): under --f64=dd; under TPU_REDUCTIONS_FORCE_DD=1,
    the JAX package's hook for running its TPU encoding elsewhere; and
    always under --quantized, whose f64 wire is defined over the dd
    planes, on the card too, so that the card runs the JAX package's
    encoding."""
    return cfg.dtype == "float64" and (
        cfg.f64 == "dd" or cfg.quantized
        or os.environ.get("TPU_REDUCTIONS_FORCE_DD") == "1")


RING_LABELS = ("dd_ring_rs_ag", "dd_ring_naive")


def bits_required(method: str, dtype: str, algorithm: str) -> bool:
    """Whether a row's result has one set of bits wherever its ranks lie
    and however its chain runs: int32 and MIN/MAX rows (exact), and the
    ring paths (the dd ring, the quantized ring), which combine in the
    ranks' order. A float SUM through psum may combine in another order
    (a card's rows first, then the cards'; NCCL's own algorithm).
    No reference analog: the JAX package holds no placement twin."""
    return (dtype == "int32" or method in ("MIN", "MAX")
            or algorithm in RING_LABELS
            or (algorithm.startswith("q") and "ring" in algorithm))


def chain_agrees(got: torch.Tensor, want: torch.Tensor, exact: bool,
                 method: str, dtype: str, n: int) -> bool:
    """Whether two chain scalars agree: the same bits where `exact`
    (bits_required), else within ops/registry.tolerance scaled by the
    larger of 1 and |want|, as _check scales its float tolerance.
    No reference analog: the JAX chain is one program, with nothing to
    hold its scalar against."""
    got, want = got.detach().cpu().reshape(1), want.detach().cpu().reshape(1)
    if exact:
        return got.dtype == want.dtype and torch.equal(
            got.view(torch.uint8), want.view(torch.uint8))
    from tpu_reductions_torch.ops.registry import tolerance
    a, b = float(got.double()), float(want.double())
    return abs(a - b) <= tolerance(method, dtype, n) * max(1.0, abs(b))


def _check_chain(chained, x_dev, k: int, exact: bool,
                 cfg: CollectiveConfig, logger: BenchLogger,
                 keep: bool) -> tuple:
    """(scalar, agrees): the timed chain's scalar at k iterations (on the
    card one more replay of its captured graph) and whether it agrees
    with the same k iterations run one by one (ChainedReduce.eager), so
    that a graph that left a collective out, or replayed one wrongly,
    fails its rows. On the CPU the chain is that eager loop already, so
    its scalar is held against nothing and is only computed to `keep`."""
    lead = x_dev[0] if isinstance(x_dev, tuple) else x_dev
    if lead.device.type != "cuda":
        return (chained(x_dev, k).cpu() if keep else None), True
    got = chained(x_dev, k)
    want = chained.eager(x_dev, k)
    ok = chain_agrees(got, want, exact, cfg.method, cfg.dtype, cfg.n)
    if not ok:
        logger.log(f"note: the chain's graph gave {got.item()!r} after {k} "
                   f"collectives, the same chain run one by one "
                   f"{want.item()!r}; its rows FAILED")
    return got.cpu(), ok


# NVLink of an H100 SXM: 900 GB/s to the other cards of the host, 450
# GB/s each way (NVIDIA's data sheet)
NVLINK_GBPS = 450.0

FALLBACK_NOTE = ("note: per-rank length does not divide by k*Q8_BLOCK; "
                 "quantized ring fell back to the exact f32 psum (full "
                 "wire)")


def _rank_lists(mesh) -> str:
    """`process 0: ranks 0-1; process 1: ranks 2-3; ...`."""
    parts = []
    for p in mesh.members:
        ranks = mesh.owned_by(p)
        contiguous = ranks == tuple(range(ranks[0], ranks[-1] + 1))
        spell = (f"{ranks[0]}-{ranks[-1]}" if contiguous and len(ranks) > 1
                 else ",".join(map(str, ranks)))
        parts.append(f"process {p}: rank{'s' if len(ranks) > 1 else ''} "
                     f"{spell}")
    return "; ".join(parts)


def _crosses_cards(mesh) -> bool:
    """Whether the mesh's hops cross cards: its ranks lie on the cards of
    more than one process."""
    return mesh.device.type == "cuda" and mesh.spans_processes


def _per_card(mesh) -> tuple:
    """(the ranks each of the mesh's processes holds, in member order,
    spelled `2` or `2, 1, 2, 1`; whether any holds more than one)."""
    counts = [len(mesh.owned_by(p)) for p in mesh.members]
    same = len(set(counts)) == 1
    return (str(counts[0]) if same else ", ".join(map(str, counts)),
            max(counts) > 1)


def _placement_note(mesh) -> str:
    where = device_mod.name(mesh.device)
    if _crosses_cards(mesh):
        per, shared = _per_card(mesh)
        inside = (f"a hop between two ranks of one card, and the combine "
                  f"of a card's own rows before an all-reduce, is a copy "
                  f"inside its memory" if shared else
                  "no hop stays inside a card")
        idle = mesh.num_processes - len(mesh.members)
        rest = (f"; the other {idle} process(es) of the group hold none "
                f"and take no part" if idle else "")
        return (f"note: the {mesh.k} ranks lie on {len(mesh.members)} "
                f"cards ({where}), {per} a card as rows of one tensor, one "
                f"process a card ({_rank_lists(mesh)}){rest}; a hop "
                f"between ranks of two cards, and every all-reduce or "
                f"all-gather between the processes, crosses NVLink through "
                f"NCCL; {inside}; each row's busbw a card is held against "
                f"NVLink's {NVLINK_GBPS:.0f} GB/s each way")
    note = (f"note: the {mesh.k} ranks are rows of one tensor on {where} "
            f"({mesh.device}); a hop between two ranks is a copy inside "
            f"it, so GB/sec and busbw are copy-and-combine rates of its "
            f"memory, not link rates")
    if mesh.spans_processes:
        note += (f"; this process holds {mesh.k_local} of them, the other "
                 f"{len(mesh.members) - 1} process(es) the rest, reached "
                 f"over gloo")
    return note


def link_share(mesh, busbw_gbps: float) -> tuple:
    """(busbw a card, that over NVLink's rate each way) of a row whose
    mesh spans processes: the registry's busbw sums the wire bytes of all
    k ranks, so a card's share is busbw over the mesh's cards, which also
    counts the hops inside a card where it holds more than one rank.
    No reference analog: the JAX rows state no link share."""
    per_card = busbw_gbps / len(mesh.members)
    return per_card, per_card / NVLINK_GBPS


def _link_note(mesh, busbw_gbps: float) -> str:
    """A cross-card row's busbw a card against NVLink, unclipped
    (link_share)."""
    per_card, ratio = link_share(mesh, busbw_gbps)
    note = (f"note: busbw {busbw_gbps:.2f} GB/s over "
            f"{len(mesh.members)} cards: {per_card:.2f} GB/s a card = "
            f"{ratio:.3f}x NVLink's {NVLINK_GBPS:.0f} GB/s each way")
    if _per_card(mesh)[1]:
        note += " (counting the hops inside a card too)"
    if ratio > 1:
        note += (" -- above the link's rate: NCCL reduces inside the "
                 "NVSwitch (NVLS) or the card's share counts copies in "
                 "its memory; not clipped")
    return note


def _run_collective_benchmark(cfg: CollectiveConfig,
                              logger: BenchLogger,
                              checkpoint=None, row_key=None,
                              on_result=None,
                              timings=("periter",)) -> List[CollectiveResult]:
    from tpu_reductions_torch.collectives import (
        bandwidth_report, host_collective_oracle, make_collective_reduce,
        make_dd_sum_all_reduce, make_key_minmax_all_reduce,
        make_quant_key_minmax_all_reduce, make_quant_sum_all_reduce,
        quant_error_bound, select_algorithm, shard_payload)
    from tpu_reductions_torch.parallel.mesh import build_mesh

    results: List[CollectiveResult] = []

    def book(res: CollectiveResult) -> CollectiveResult:
        if mesh.spans_processes:
            res.cards = len(mesh.members)
            if _crosses_cards(mesh):
                res.nvlink_share = link_share(mesh, res.busbw_gbps)[1]
        # persisted the moment it exists
        results.append(res)
        if checkpoint is not None:
            checkpoint.add(res.to_dict())
        return res

    mesh = build_mesh(num_devices=cfg.num_devices,
                      mesh_shape=cfg.mesh_shape, mapping=cfg.mapping,
                      mode=cfg.mode, platform=cfg.platform,
                      local_ranks=cfg.provisioned_ranks)
    if not mesh.member:
        # a process outside the mesh (fewer ranks than processes) holds
        # no rank: it enters none of the mesh's collectives and has no row
        return results
    k = mesh.k

    # --- payload staging (untimed, like reduce.c's fill before its loop)
    dtype = cfg.dtype
    method = cfg.method
    dd_planes = _use_dd_planes(cfg)
    x_host = _build_payload(cfg, k)
    rooted = cfg.rooted
    per_rank = cfg.n // k
    dd_scale = 0    # power-of-two pre-scale exponent of the dd SUM planes
    sel = select_algorithm(method, dtype, k, per_rank, rooted=rooted,
                           quantized=cfg.quantized, bits=cfg.quant_bits,
                           dd_planes=dd_planes)
    algorithm = sel.algorithm
    ledger.emit("collective.select", algorithm=algorithm,
                method=method, dtype=dtype, ranks=k,
                wire_factor=round(sel.wire_factor, 6),
                quantized=bool(cfg.quantized),
                bits=(cfg.quant_bits if cfg.quantized else None))
    if dd_planes:
        from tpu_reductions_torch.ops.dd_reduce import (host_key_encode,
                                                        host_split_scaled)
        if rooted == "scatter":
            # the pair collectives are all-reduce shaped; the rows keep
            # the requested mode, the algorithm column what ran
            logger.log("note: --rooted=scatter is not supported on the "
                       "f64 pair paths; running all-reduce")
        elif rooted == "root":
            logger.log("note: --rooted=root on the f64 pair paths is the "
                       "pair all-reduce (replicated output; root holds "
                       "the full array)")
        x_np = x_host.numpy()
        if method == "SUM":
            hi, lo, dd_scale = host_split_scaled(x_np)
            if cfg.quantized:
                coll = make_quant_sum_all_reduce(mesh, bits=cfg.quant_bits,
                                                 dtype="float64")
                if algorithm == "all_reduce":
                    logger.log(FALLBACK_NOTE)
            else:
                coll = make_dd_sum_all_reduce(mesh)
        else:
            hi, lo = host_key_encode(x_np)
            if cfg.quantized:
                coll = make_quant_key_minmax_all_reduce(
                    method, mesh, bits=cfg.quant_bits, dtype="float64")
            else:
                coll = make_key_minmax_all_reduce(method, mesh)
        x_dev = (shard_payload(hi, mesh), shard_payload(lo, mesh))

        def run(x):
            return coll(*x)
    elif cfg.quantized:
        if rooted != "none":
            # the quantized ring replicates its output: root holds it all
            logger.log("note: --rooted with --quantized runs the ring "
                       "all-reduce (replicated output)")
        x_dev = shard_payload(x_host, mesh)
        if method == "SUM":
            coll = make_quant_sum_all_reduce(mesh, bits=cfg.quant_bits,
                                             dtype=dtype)
            if algorithm == "all_reduce":
                logger.log(FALLBACK_NOTE)
        else:
            coll = make_quant_key_minmax_all_reduce(
                method, mesh, bits=cfg.quant_bits, dtype=dtype)
        run = coll
    else:
        x_dev = shard_payload(x_host, mesh)
        coll = make_collective_reduce(method, mesh, rooted=rooted)
        run = coll

    # the bytes really reduced: k * (n // k) elements (the remainder is
    # dropped, as the reference's N/commSize split drops it)
    payload_bytes = x_host.numel() * x_host.element_size()

    logger.log(_placement_note(mesh))
    logger.log(COLLECTIVE_HEADER)

    # the interruptible unit of a rank sweep, then one span per hop
    # program, held open over the warm-up and the timed phase
    fault_point("collective.hop")
    hop_span = contextlib.ExitStack()
    hop_span.enter_context(trace.child())
    ledger.emit("collective.launch", algorithm=algorithm,
                method=method, dtype=dtype, ranks=k, n=int(cfg.n))
    t_launch = Stopwatch()
    t_launch.start()

    def row(dt: float) -> dict:
        bw = bandwidth_report(payload_bytes, k, dt, algorithm=algorithm)
        logger.log(collective_row(dtype, method, k, bw["reference_gbps"]))
        if _crosses_cards(mesh):
            logger.log(_link_note(mesh, bw["busbw_gbps"]))
        return bw

    chain_scalar = None

    def done() -> None:
        if on_result is not None:
            on_result(out, coll, chain_scalar)
        ledger.emit("collective.done", algorithm=algorithm,
                    method=method, dtype=dtype, ranks=k,
                    wall_s=round(t_launch.stop(), 6), rows=len(results))
        hop_span.close()

    def sync():
        device_mod.synchronize(mesh.device)

    from tpu_reductions_torch.exec import core as exec_core
    from tpu_reductions_torch.exec.plan import launch_plan

    def warmup(ctx):
        out = None
        for _ in range(max(cfg.warmup, 1)):      # reduce.c:61-64
            out = run(x_dev)
            sync()
            ctx.tick()
        return out

    out = exec_core.run(launch_plan(
        f"collective/{algorithm}", "collective", warmup,
        timing="chained", heartbeat_phase="collective.warmup",
        method=method, dtype=dtype, ranks=k, n=int(cfg.n)))

    expect = host_collective_oracle(x_host, k, method) if cfg.verify \
        else None
    # quantized SUM is held to its declared bound (collectives/quant.py)
    # wherever it ran, the exact psum fallback included: the f64 planes'
    # f32 collapse lies inside the bound; quantized MIN/MAX stays exact
    quant_atol = 0.0
    if cfg.quantized and method == "SUM":
        quant_atol = quant_error_bound(method, dtype, cfg.quant_bits, k,
                                       float(x_host.abs().max()))

    def verify(out) -> QAStatus:
        if expect is None:
            return QAStatus.PASSED
        got, selector = _gather_result(out, method, coll, dd_planes,
                                       scale_exp=dd_scale)
        ok = _check(got, expect, method, dtype, cfg, selector=selector,
                    quant_atol=quant_atol)
        return QAStatus.PASSED if ok else QAStatus.FAILED

    def chained_rows(verified: Optional[QAStatus]) -> tuple:
        # each "retry" is one slope sample over chain_span data-dependent
        # collectives (one CUDA graph a trip on the card), chaining the
        # collective that was warmed up and is verified here (or by the
        # periter rows just before, on the same payload); the graph's
        # scalar is then held against the chain run one by one
        from tpu_reductions_torch.collectives import (
            make_chained_collective, make_chained_pair_collective)
        from tpu_reductions_torch.utils.timing import time_chained
        chained = (make_chained_pair_collective(method, coll) if dd_planes
                   else make_chained_collective(method, coll=coll))
        k_hi = 1 + cfg.chain_span
        try:
            sw = time_chained(chained, x_dev, k_lo=1, k_hi=k_hi,
                              reps=cfg.retries)
            scalar, agrees = _check_chain(
                chained, x_dev, k_hi,
                bits_required(method, dtype, algorithm), cfg, logger,
                keep=on_result is not None)
        finally:
            chained.close()
        if verified is None:
            verified = verify(out)
        status = verified if agrees else QAStatus.FAILED
        for rep, dt in enumerate(sw.samples):
            if dt <= 0:
                # a non-positive slope carries no bandwidth: the rep is
                # WAIVED with no row printed (a failed verification still
                # fails)
                logger.log(f"note: rep {rep} slope non-positive "
                           f"(interconnect stall); rep WAIVED")
                book(CollectiveResult(
                    method, dtype, cfg.n, k, rep, rooted, 0.0, 0.0, 0.0,
                    status if status == QAStatus.FAILED
                    else QAStatus.WAIVED, algorithm))
                continue
            bw = row(dt)
            book(CollectiveResult(
                method, dtype, cfg.n, k, rep, rooted, dt,
                bw["reference_gbps"], bw["busbw_gbps"], status, algorithm))
        return scalar, verified

    def periter_rows() -> QAStatus:
        nonlocal out
        status = None
        for rep in range(cfg.retries):
            # the previous result is released first, so that the timed
            # call reuses its memory instead of allocating anew
            out = None
            if mesh.spans_processes:
                # the processes enter each timed collective together:
                # each verified the previous repeat on its own, and rank
                # 0 would otherwise time that skew with the collective
                import torch.distributed as dist
                dist.barrier(group=mesh.group)
            sw = Stopwatch()
            sw.start()
            out = run(x_dev)
            sync()
            dt = sw.stop()
            status = verify(out)
            bw = row(dt)
            book(CollectiveResult(
                method, dtype, cfg.n, k, rep, rooted, dt,
                bw["reference_gbps"], bw["busbw_gbps"], status, algorithm))
        return status

    status = None
    for timing in timings:
        if timing == "chained":
            chain_scalar, status = chained_rows(status)
        else:
            status = periter_rows()
    done()
    return results


def _gather_result(out, method: str, coll, dd_planes: bool,
                   scale_exp: int = 0):
    """This process's view of the result for verification, with its
    selector (collectives.local_view_and_selection); on the pair paths
    the planes decoded: SUM's hi + lo with the exact power-of-two
    pre-scale of host_split_scaled undone, MIN/MAX's keys decoded."""
    from tpu_reductions_torch.collectives import local_view_and_selection
    if dd_planes:
        hi_v, sel = local_view_and_selection(out[0], coll)
        lo_v, _ = local_view_and_selection(out[1], coll)
        if method == "SUM":
            hi = np.asarray(hi_v, dtype=np.float64)
            lo = np.asarray(lo_v, dtype=np.float64)
            return np.ldexp(hi + lo, scale_exp), sel
        from tpu_reductions_torch.ops.dd_reduce import host_key_decode
        return host_key_decode(hi_v, lo_v), sel
    return local_view_and_selection(out, coll)


def _check(got: np.ndarray, expect: np.ndarray, method: str, dtype: str,
           cfg: CollectiveConfig, selector=slice(None),
           quant_atol: float = 0.0) -> bool:
    """Acceptance as the JAX driver's (reduction.cpp:750-780): ints and
    selections exact (the key-pair MIN/MAX too), quantized sums within
    their declared bound `quant_atol`, other float sums within a scaled
    tolerance."""
    if cfg.rooted != "none" and got.size != expect.size:
        # a reduce-scatter view: this process's slices, at the global
        # positions `selector` names
        expect = expect.reshape(-1)[selector]
    if quant_atol > 0:
        return bool(np.allclose(got.astype(np.float64),
                                expect.astype(np.float64), rtol=0,
                                atol=quant_atol))
    if dtype == "int32" or method in ("MIN", "MAX"):
        if dtype == "bfloat16":
            return bool(np.allclose(got.astype(np.float64),
                                    expect.astype(np.float64), rtol=1e-2))
        return bool(np.array_equal(got, expect))
    rtol = {"float32": 1e-6, "float64": 1e-12, "bfloat16": 1e-2}[dtype]
    return bool(np.allclose(got.astype(np.float64),
                            expect.astype(np.float64), rtol=rtol,
                            atol=rtol * max(1.0, float(np.abs(
                                expect.astype(np.float64)).max()))))


def run_collective_suite(cfg: CollectiveConfig,
                         logger: Optional[BenchLogger] = None
                         ) -> List[CollectiveResult]:
    """The full grid of one reduce.c run: for each dtype in {int32,
    float64}, MAX, MIN and SUM (reduce.c:71-97), `retries` each."""
    results = []
    for dtype in ("int32", "float64"):
        for method in ("MAX", "MIN", "SUM"):   # reduce.c:73's order
            sub = dataclasses.replace(cfg, method=method, dtype=dtype)
            results.extend(run_collective_benchmark(sub, logger=logger))
    return results


def _rank0_hint(args) -> bool:
    """Whether this process will report, decided before parsing, so that
    the RUNNING marker precedes any parse or bring-up failure: only an
    explicit --process-id other than 0 demotes a process."""
    for i, a in enumerate(args):
        if a.startswith("--process-id"):
            val = (a.split("=", 1)[1] if "=" in a
                   else (args[i + 1] if i + 1 < len(args) else "0"))
            try:
                return int(val) == 0
            except ValueError:
                return True
    return True


def bring_up(cfg: CollectiveConfig) -> tuple:
    """The run's devices and processes, before any collective: this
    process's device (on the card with --num-processes > 1 its own card,
    refused where the host's processes outnumber its cards), then the
    join (NCCL on the card, gloo on the CPU; parallel/mesh.py). Returns
    (joined, reporting): whether it joined a group, which the caller
    destroys, and whether this process reports (rank 0).
    The bring-up of tpu_reductions/bench/collective_driver.py:585."""
    from tpu_reductions_torch.parallel.mesh import initialize_distributed
    nproc = cfg.num_processes or 1
    device_mod.resolve(cfg.platform, process_id=cfg.process_id,
                       num_processes=nproc)
    joined = initialize_distributed(
        coordinator_address=cfg.coordinator, num_processes=nproc,
        process_id=cfg.process_id, platform=cfg.platform)
    return joined, nproc <= 1 or cfg.process_id in (None, 0)


def main(argv=None) -> int:
    """CLI: RUNNING marker, parse, bring-up, run, terminal marker; returns
    the QA exit code (module docstring).
    The counterpart of tpu_reductions/bench/collective_driver.py:585."""
    from tpu_reductions_torch.config import parse_collective
    from tpu_reductions_torch.utils.qa import qa_start

    args = list(argv) if argv else sys.argv[1:]
    if any(a in ("-h", "--help") for a in args):
        parse_collective(argv)          # prints help, SystemExit(0)
    rank0 = _rank0_hint(args)
    if rank0:
        qa_start(NAME, args)
    # a printed RUNNING always gets its terminal marker from this process
    qa_out = open(os.devnull, "w") if not rank0 else None
    try:
        return _main(argv, qa_out)
    finally:
        if qa_out is not None:
            qa_out.close()


def _main(argv, qa_out) -> int:
    from tpu_reductions_torch.config import parse_collective
    from tpu_reductions_torch.utils.qa import qa_finish

    try:
        cfg = parse_collective(argv)
    except SystemExit as e:
        if e.code in (0, None):
            return 0
        if isinstance(e.code, str):
            # a validation exit carries its reason; argparse's own
            # refusals printed theirs
            print(f"error: {e.code}", file=sys.stderr)
        # FAILED = 1, not argparse's 2
        return qa_finish(NAME, QAStatus.FAILED, out=qa_out)
    except Exception as e:   # a value CollectiveConfig refuses
        print(f"error: {type(e).__name__}: {e}", file=sys.stderr)
        return qa_finish(NAME, QAStatus.FAILED, out=qa_out)
    from tpu_reductions_torch.exec.core import maybe_arm
    from tpu_reductions_torch.obs.ledger import arm_session
    arm_session("bench.collective_driver", argv=list(argv) if argv else sys.argv[1:])
    maybe_arm(cfg.platform)
    try:
        joined, reporting = bring_up(cfg)
    except Exception as e:   # no card, too few cards, a dead coordinator
        print(f"error: bring-up failed: {type(e).__name__}: {e}",
              file=sys.stderr)
        return qa_finish(NAME, QAStatus.FAILED, out=qa_out)
    try:
        # --qatest: markers only; a process other than rank 0 prints no
        # rows (reduce.c prints from rank 0 only, :68,81,95)
        quiet = cfg.qatest or not reporting
        logger = BenchLogger(None, None,
                             console=open(os.devnull, "w") if quiet
                             else None)
        ck = None
        if cfg.out and reporting:
            from tpu_reductions_torch.bench.resume import Checkpoint
            ck = Checkpoint(cfg.out, collective_meta(cfg),
                            key_fn=lambda r: r.get("repeat"))
        try:
            results = run_collective_benchmark(cfg, logger=logger,
                                               checkpoint=ck)
        except Exception as e:  # fail fast with the QA protocol intact
            logger.log(f"error: {type(e).__name__}: {e}")
            print(f"error: {type(e).__name__}: {e}", file=sys.stderr)
            return qa_finish(NAME, QAStatus.FAILED, out=qa_out)
        finally:
            if quiet:
                logger.console.close()
        if ck is not None:
            ck.finalize()
        ok = all(r.passed or r.status == QAStatus.WAIVED for r in results)
        return qa_finish(NAME, QAStatus.PASSED if ok else QAStatus.FAILED,
                         out=qa_out)
    finally:
        if joined:
            from tpu_reductions_torch.parallel.mesh import leave_distributed
            leave_distributed()


if __name__ == "__main__":
    sys.exit(main())
