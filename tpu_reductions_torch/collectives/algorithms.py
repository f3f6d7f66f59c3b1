"""Collective algorithm registry and the one selector.

The port's copy of tpu_reductions/collectives/algorithms.py, pure host
code: every wire pattern the suite can run, with its declared cost model
(wire bytes per rank over local payload bytes, the NCCL busbw convention,
and the sequential hop count), `select_algorithm`, which names the
pattern a constructor will run, and `bandwidth_report`, which prices a row
through the same registry. Every label and factor equals the JAX
package's for every input (tests/test_torch_collectives.py).

On one card the ranks are rows of one tensor (parallel/mesh.py), so a
"wire" byte is a copy inside the card's memory: busbw is this registry's
factor applied to that time, not a link rate.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from tpu_reductions_torch.collectives.quant import (KEY_BITS, QUANT_BITS,
                                              QUANT_BLOCK, Q8_BLOCK,
                                              quant_ring_applies,
                                              quant_supported)
from tpu_reductions_torch.collectives.rings import grid_factors


@dataclasses.dataclass(frozen=True)
class Algorithm:
    """One registered wire pattern: its busbw factor, its sequential
    hop count (the α term of the cost model) and how many ring
    directions it drives concurrently (bidirectional rings halve the
    per-link serialized bytes at the same total)."""

    name: str
    wire_factor: Callable[[int], float]   # wire bytes/rank ÷ payload bytes
    steps: Callable[[int], int]           # sequential ppermute hops
    dirs: int = 1                         # concurrent link directions
    note: str = ""


def _ring_factor(k: int) -> float:
    return 2 * (k - 1) / k


def _torus_factor(k: int) -> float:
    # row RS (b-1)/b + column all-reduce of the L/b chunk 2(a-1)/(a*b)
    # + row AG (b-1)/b — for k = a*b this telescopes to exactly the
    # ring's 2(k-1)/k when a, b > 1 (bandwidth-optimal, fewer hops)
    a, b = grid_factors(k)
    return 2 * (b - 1) / b + 2 * (a - 1) / (a * b)


def _torus_steps(k: int) -> int:
    a, b = grid_factors(k)
    return 2 * (a - 1) + 2 * (b - 1)


def _quant_factor(bits: int, elem_bytes: int) -> Callable[[int], float]:
    # ring factor scaled by the wire compression: b-bit carrier + one
    # f32 scale per QUANT_BLOCK elements, vs elem_bytes per element
    return lambda k, _b=bits, _e=elem_bytes: (
        _ring_factor(k) * (_b / 8 + 4 / QUANT_BLOCK) / _e)


def _key_factor(bits: int, key_bytes: int) -> Callable[[int], float]:
    # coarse b-bit key phase + the exact full-key resolve phases, vs
    # the unquantized key wire (key_bytes per element)
    return lambda k, _b=bits, _e=key_bytes: (
        _ring_factor(k) * (_b / 8 + _e) / _e)


def _build_registry() -> Dict[str, Algorithm]:
    reg = {}

    def add(name, wire_factor, steps, dirs=1, note=""):
        reg[name] = Algorithm(name, wire_factor, steps, dirs, note)

    # the XLA-native family (collectives/core.make_collective_reduce)
    add("all_reduce", _ring_factor, lambda k: 2 * (k - 1),
        note="psum/pmin/pmax; modeled as the ring it lowers to")
    add("reduce_scatter", lambda k: (k - 1) / k, lambda k: k - 1,
        note="psum_scatter / ppermute halving butterfly")
    add("all_reduce_slice", _ring_factor, lambda k: 2 * (k - 1),
        note="slice fallback: pays the full all-reduce wire")
    add("reduce_to_root_rs_ag", _ring_factor, lambda k: 2 * (k - 1),
        note="RS+AG root semantics (reduce.c:76,90)")
    add("reduce_to_root_allreduce", _ring_factor, lambda k: 2 * (k - 1),
        note="root semantics via plain all-reduce")

    # the explicit-topology ring family (collectives/rings.py)
    add("ring_rs_ag", _ring_factor, lambda k: 2 * (k - 1),
        note="explicit single-direction ring RS+AG")
    add("bidir_ring_rs_ag", _ring_factor, lambda k: 2 * (k - 1), dirs=2,
        note="disjoint halves each way; both link directions busy")
    add("torus2d_rs_ag", _torus_factor, _torus_steps,
        note="row RS, column all-reduce, row AG over grid_factors(k)")
    add("naive_accumulate", lambda k: float(k - 1), lambda k: k - 1,
        note="k-1 full-L hops; the only fit for indivisible lengths")

    # the f64 pair family (collectives/core.py)
    add("dd_ring_rs_ag", _ring_factor, lambda k: 2 * (k - 1),
        note="dd pair ring, compensated accumulation per hop")
    add("dd_ring_naive", lambda k: float(k - 1), lambda k: k - 1,
        note="dd accumulate-around-the-ring fallback")
    add("key_two_phase_all_reduce", _ring_factor, lambda k: 4 * (k - 1),
        note="exact f64 MIN/MAX on order-key pairs, two phases")

    # the quantized family (collectives/quant.py); elem_bytes is the
    # UNquantized payload each factor compresses against
    for bits in QUANT_BITS:
        add(f"q{bits}_ring_rs_ag", _quant_factor(bits, 4),
            lambda k: 2 * (k - 1),
            note=f"{bits}-bit block-scaled f32 SUM ring")
        add(f"q{bits}_bf16_ring_rs_ag", _quant_factor(bits, 2),
            lambda k: 2 * (k - 1),
            note=f"{bits}-bit block-scaled bf16 SUM ring (f32 accum)")
        add(f"q{bits}_dd_ring_rs_ag", _quant_factor(bits, 8),
            lambda k: 2 * (k - 1),
            note=f"{bits}-bit block-scaled ring over collapsed dd sum")
    for bits in KEY_BITS:
        add(f"q{bits}_key_minmax_all_reduce", _key_factor(bits, 4),
            lambda k: 4 * (k - 1),
            note=f"{bits}-bit coarse keys + exact f32 resolve (EXACT)")
        add(f"q{bits}_key_two_phase_all_reduce", _key_factor(bits, 8),
            lambda k: 6 * (k - 1),
            note=f"{bits}-bit coarse keys + exact f64 pair resolve "
                 f"(EXACT)")

    # the redistribution primitives (reshard/, Zhang et al. 2112.01075):
    # payload convention is GLOBAL array bytes (not the per-rank local
    # payload of the all-reduce family) — a reshard moves one logical
    # array, and its plans sum wire over steps of the SAME global array
    add("reshard_all_gather", lambda k: (k - 1) / k, lambda k: k - 1,
        note="ring all-gather of the k local blocks (sharded -> "
             "replicated)")
    add("reshard_dynamic_slice", lambda k: 0.0, lambda k: 0,
        note="local slice (replicated -> sharded); zero wire")
    add("reshard_collective_permute", lambda k: (k - 1) / (k * k),
        lambda k: k - 1,
        note="ring all-to-all: k-1 rotation hops of 1/k**2 pieces "
             "(sharded dim A -> sharded dim B); a factor k under the "
             "naive all-gather-then-slice wire")
    add("reshard_reduce_scatter", lambda k: (k - 1) / k, lambda k: k - 1,
        note="psum_scatter of per-rank partial addends -> sharded sum")
    # quantized wire variants (f32 payloads only; bits/8-bit carrier +
    # one f32 scale per QUANT_BLOCK elements, same compression as the
    # quantized SUM rings above)
    for bits in QUANT_BITS:
        c = (bits / 8 + 4 / QUANT_BLOCK) / 4
        add(f"reshard_all_gather_q{bits}",
            lambda k, _c=c: _c * (k - 1) / k, lambda k: k - 1,
            note=f"{bits}-bit block-scaled all-gather wire")
        add(f"reshard_collective_permute_q{bits}",
            lambda k, _c=c: _c * (k - 1) / (k * k), lambda k: k - 1,
            note=f"{bits}-bit block-scaled all-to-all wire")
    return reg


REGISTRY: Dict[str, Algorithm] = _build_registry()

# Wire bytes per rank / local payload bytes, by algorithm label — the
# compat view of the registry (bandwidth_report and the PR-4-era
# callers index it directly).
WIRE_FACTORS = {name: alg.wire_factor for name, alg in REGISTRY.items()}


@dataclasses.dataclass(frozen=True)
class Selection:
    """What the selector decided: the label of the wire pattern that
    WILL run (never the one merely requested)
    plus its declared costs for this k."""

    algorithm: str
    wire_factor: float
    steps: int
    note: str = ""


def _selection(name: str, k: int, note: str = "") -> Selection:
    alg = REGISTRY[name]
    return Selection(name, alg.wire_factor(k), alg.steps(k),
                     note or alg.note)


# ---------------------------------------------------------------------------
# per-family algorithm predicates (shared with the constructors, which use
# the same trace-time conditions — the single-source-of-truth rule)
# ---------------------------------------------------------------------------

# Rooted-semantics modes (the MPI_Reduce root=0 axis, reduce.c:76,90):
#   none     all-reduce; every rank holds the full reduced array
#   scatter  reduce-scatter; each rank keeps its L/k slice (the rooted
#            reduce's wire cost, not its recvbuf semantics)
#   root     reduce-scatter + all-gather; the root rank holds the FULL
#            reduced array — true MPI_Reduce recvbuf semantics. (Every
#            other rank holds it too: a replicated superset of MPI's
#            undefined non-root recvbuf, because the gather rides the
#            same ring all ranks already relay.)
ROOTED_MODES = ("none", "scatter", "root")


def normalize_rooted(rooted) -> str:
    """Accept legacy bools (False -> 'none', True -> 'scatter') and mode
    strings; return one of ROOTED_MODES."""
    if isinstance(rooted, str):
        if rooted not in ROOTED_MODES:
            raise ValueError(f"rooted must be one of {ROOTED_MODES}, "
                             f"got {rooted!r}")
        return rooted
    return "scatter" if rooted else "none"


def _halving_applies(k: int, per_rank_len: int) -> bool:
    """The ppermute recursive-halving butterfly needs a power-of-two rank
    count and a per-rank length divisible by k (each of log2(k) rounds
    halves it). Static at trace time."""
    return k > 1 and (k & (k - 1)) == 0 and per_rank_len % k == 0


def collective_algorithm(method: str, k: int, per_rank_len: int,
                         rooted) -> str:
    """The algorithm `make_collective_reduce` will actually execute for
    this geometry — the single source of truth for bandwidth accounting
    (the constructors use the same predicates): the busbw column describes
    the algorithm that ran, not the one that was requested."""
    mode = normalize_rooted(rooted)
    method = method.upper()
    if mode == "none" or k == 1:
        return "all_reduce"
    if method == "SUM":
        scatterable = per_rank_len % k == 0
    else:
        scatterable = _halving_applies(k, per_rank_len)
    if mode == "scatter":
        return "reduce_scatter" if scatterable else "all_reduce_slice"
    return ("reduce_to_root_rs_ag" if scatterable
            else "reduce_to_root_allreduce")


def dd_ring_algorithm(k: int, per_rank_len: int) -> str:
    """Which wire pattern make_dd_sum_all_reduce executes (same predicate
    as its `local` dispatch)."""
    if k > 1 and per_rank_len % k == 0:
        return "dd_ring_rs_ag"
    return "dd_ring_naive"


def q8_ring_algorithm(k: int, per_rank: int) -> str:
    """Wire pattern the original int8 quantized SUM takes for this
    geometry — accounting must use it."""
    return quant_ring_algorithm(k, per_rank, bits=8, dtype="float32")


def quant_ring_algorithm(k: int, per_rank: int, bits: int = 8,
                         dtype: str = "float32") -> str:
    """The generalized-bits spelling of q8_ring_algorithm: the label
    make_quant_sum_all_reduce's dispatch actually runs, per dtype."""
    if not quant_ring_applies(k, per_rank, bits):
        return "all_reduce"     # exact full-wire psum fallback
    if dtype == "bfloat16":
        return f"q{bits}_bf16_ring_rs_ag"
    if dtype == "float64":
        return f"q{bits}_dd_ring_rs_ag"
    return f"q{bits}_ring_rs_ag"


def topology_supported(topology: str, k: int, per_rank_len: int) -> bool:
    """Geometry gate of the explicit ring family — the same trace-time
    conditions rings.make_topology_all_reduce dispatches on."""
    if k == 1:
        return topology == "naive"
    if topology == "naive":
        return True
    if topology == "ring":
        return per_rank_len % k == 0
    if topology == "bidir":
        return per_rank_len % (2 * k) == 0
    if topology == "torus2d":
        a, b = grid_factors(k)
        return (a > 1 and b > 1 and per_rank_len % b == 0
                and (per_rank_len // b) % a == 0)
    raise ValueError(f"unknown topology {topology!r}")


_TOPOLOGY_LABELS = {"ring": "ring_rs_ag", "bidir": "bidir_ring_rs_ag",
                    "torus2d": "torus2d_rs_ag",
                    "naive": "naive_accumulate"}


def select_algorithm(method: str, dtype: str, k: int, per_rank_len: int,
                     *, rooted="none", quantized: bool = False,
                     bits: int = 8, dd_planes: bool = False,
                     topology: str = None) -> Selection:
    """THE selector: per (op, dtype, k, L) — plus the driver-level mode
    flags — name the wire pattern that will run and its declared costs.
    Every branch returns EXACTLY the label the matching constructor
    dispatches to, so resume artifacts, busbw accounting and the
    committed curve all agree with the code (tests/test_torch_collectives.py
    holds every branch against the JAX package's).

    Precedence: an explicit topology ask (the curve's ring-family
    instrument) > quantized > the f64 pair planes > the XLA-native
    family under the rooted mode."""
    method = method.upper()
    if topology is not None:
        topo = topology
        if not topology_supported(topo, k, per_rank_len):
            # the constructor's own degrade chain: ring, else naive
            topo = ("ring" if topology_supported("ring", k, per_rank_len)
                    else "naive")
        if k == 1:
            return _selection("all_reduce", k,
                              note="single rank: no wire")
        note = "" if topo == topology else (
            f"{topology} unsupported at (k={k}, L={per_rank_len}); "
            f"fell back to {topo}")
        return _selection(_TOPOLOGY_LABELS[topo], k, note)
    if quantized:
        if not quant_supported(method, dtype, bits):
            raise ValueError(
                f"quantized {method}/{dtype}/{bits}b has no registered "
                f"algorithm (collectives/quant.quant_supported gates "
                f"this upstream)")
        if method in ("MIN", "MAX"):
            name = (f"q{bits}_key_two_phase_all_reduce"
                    if dtype == "float64"
                    else f"q{bits}_key_minmax_all_reduce")
            return _selection(name, k)
        name = quant_ring_algorithm(k, per_rank_len, bits, dtype)
        note = ("" if name != "all_reduce" else
                f"per-rank length does not divide by k*{QUANT_BLOCK}; "
                f"quantized ring fell back to the exact psum "
                f"(full wire)")
        return _selection(name, k, note)
    if dd_planes:
        if method == "SUM":
            return _selection(dd_ring_algorithm(k, per_rank_len), k)
        return _selection("key_two_phase_all_reduce", k)
    return _selection(collective_algorithm(method, k, per_rank_len,
                                           rooted), k)


def algorithm_cost(name: str, k: int, payload_bytes: int,
                   alpha_s: float, beta_s_per_byte: float) -> float:
    """The α-β cost model over registry entries: sequential hops pay
    alpha_s each, wire bytes pay beta_s_per_byte each, divided across
    the directions the pattern keeps busy. Used by choose_topology and
    priced per-window by sched/priors (which learns α, β from ledgers;
    these are the classic LogP-style terms Zhang et al.'s portable
    decomposition plans against — PAPERS.md 2112.01075)."""
    alg = REGISTRY[name]
    return (alg.steps(k) * alpha_s
            + alg.wire_factor(k) * payload_bytes * beta_s_per_byte
            / alg.dirs)


def choose_topology(k: int, per_rank_len: int, elem_bytes: int = 4, *,
                    alpha_s: float = 20e-6,
                    beta_s_per_byte: float = 1 / (100e9)) -> str:
    """Cost-model pick among the supported explicit-ring topologies for
    this geometry (the per-device-count 2D-torus/bidirectional
    selection). The defaults are the JAX package's, which model its TPU
    links: tens of microseconds per hop, ~100 GB/s-class links. Latency
    dominates small payloads (torus2d's fewer hops win), bandwidth big
    ones (bidir's doubled link duty wins)."""
    payload = per_rank_len * elem_bytes
    candidates = [t for t in ("ring", "bidir", "torus2d", "naive")
                  if topology_supported(t, k, per_rank_len)]
    return min(candidates,
               key=lambda t: algorithm_cost(_TOPOLOGY_LABELS[t], k,
                                            payload, alpha_s,
                                            beta_s_per_byte))


def bandwidth_report(payload_bytes: int, k: int, time_s: float,
                     rooted=False, algorithm: str = None) -> dict:
    """All the bandwidth conventions in one place (package docstring).

    `algorithm` names the wire pattern that ACTUALLY ran (use
    `select_algorithm` / the per-family helpers to derive it); the busbw
    factor follows it — a slice fallback that paid all-reduce wire cost
    reports all-reduce busbw, not the reduce-scatter factor of the mode
    that was merely requested. When omitted,
    the happy-path label for `rooted` is assumed."""
    if algorithm is None:
        algorithm = {"none": "all_reduce", "scatter": "reduce_scatter",
                     "root": "reduce_to_root_rs_ag"}[normalize_rooted(rooted)]
    if algorithm not in WIRE_FACTORS:
        raise ValueError(f"unknown algorithm {algorithm!r}; one of "
                         f"{sorted(WIRE_FACTORS)}")
    ref_gbps = payload_bytes / time_s / 1e9 if time_s > 0 else float("inf")
    algbw = ref_gbps
    return {
        "reference_gbps": ref_gbps,       # total-bytes / time (reduce.c:79)
        "algbw_gbps": algbw,
        "busbw_gbps": algbw * WIRE_FACTORS[algorithm](k),
        "ranks": k,
        "payload_bytes": payload_bytes,
        "collective": algorithm,
    }
