"""Flags and configuration of the single-chip and collective benchmarks.

The counterpart of tpu_reductions/config.py (`DTYPE_ALIASES`, `METHODS`,
the kernel ids, `ReduceConfig`, `parse_single_chip`, and at the end the
collective CLI's `CollectiveConfig`, `build_collective_parser` and
`parse_collective`, with --platform and --f64 added). Flags keep the JAX
package's spelling and defaults. The single-chip CLI's:

  --method={SUM|MIN|MAX}       required
  --type={int|float|double}    or int32/float32/float64/bfloat16
  --n, --seed, --threads, --maxblocks, --cpufinal, --cputhresh
  --kernel                     6 (single pass), 7 (partials), 8
                               (elementwise), 9 (tensor-core SUM over float
                               dtypes; other pairs WAIVE) and 10 (streamed
                               through shared memory) run; 0-5 WAIVE
  --streambuffers              k10's pipeline depth (default 4)
  --backend={auto|cuda|torch}  cuda: the hand-written kernels (auto picks
                               them); torch: the comparator
  --f64={native|dd}            float64 natively on the card (default), or
                               the JAX package's route for a chip without
                               native f64: two 32-bit planes through the
                               pair kernel (ops/dd_reduce.py); other dtypes
                               ignore it
  --stream, --chunk-bytes      the streaming pipeline (ops/stream.py):
                               chunks of at most --chunk-bytes (default
                               `stage_chunk_bytes`) copied to the card
                               while the previous one is folded
  --shmoo, --shmoo-min/-max    the size sweep 2^min..2^max (default 10,
                               24; bench/sweep.run_shmoo)
  --check                      the kernel (at the row's --cpufinal,
                               --cputhresh and --streambuffers), its plain
                               version and the torch comparator against
                               the host oracle before the run
                               (utils/debug.consistency_check); with
                               --backend=torch the comparator is the timed
                               one
  --trace DIR                  a torch.profiler trace of the timed call
  --platform={gpu|cpu}         the card by default
  --iterations                 default 100; an explicit value also bounds
                               a chained shmoo's span
  --warmup --device --logfile --masterlog --qatest --no-verify --timing
  --chainreps --stat

Staging (utils/staging.py) reads two environment knobs, as the JAX
package does: TPU_REDUCTIONS_STAGE_CHUNK_BYTES, the per-copy bound
(default 256 MiB; --chunk-bytes overrides it for --stream), and
TPU_REDUCTIONS_STAGE_THRESHOLD_BYTES, above which a payload stages in
chunks (default twice the chunk bound).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional

DTYPE_ALIASES = {
    "int": "int32",
    "float": "float32",
    "double": "float64",
    "int32": "int32",
    "float32": "float32",
    "float64": "float64",
    "bfloat16": "bfloat16",
}

METHODS = ("SUM", "MIN", "MAX")
# The reduction family (ops/family/): prefix scan, segmented reductions
# and index-carrying extremes. Served methods and family-spot cells, not
# benchmark methods: ReduceConfig takes METHODS only.
FAMILY_METHODS = ("SCAN", "SEGSUM", "SEGMIN", "SEGMAX", "ARGMIN", "ARGMAX")
SERVED_METHODS = METHODS + FAMILY_METHODS
BACKENDS = ("auto", "cuda", "torch")
PLATFORMS = ("gpu", "cpu")
TIMINGS = ("periter", "bulk", "fetch", "chained")
F64_ROUTES = ("native", "dd")   # the JAX package's f64_strategy() routes

# Kernel ids of the JAX package (its config.py:224-236). 0-5 WAIVE, as
# the reference emptied them.
LIVE_KERNELS = (6, 7, 8, 9, 10)
KERNEL_SINGLE_PASS = 6
KERNEL_TWO_PASS = 7
KERNEL_ELEMENTWISE = 8
KERNEL_MXU = 9          # SUM over float dtypes, on the tensor cores
KERNEL_STREAM = 10      # fed by a `stream_buffers`-deep copy pipeline
STREAM_BUFFERS = 4      # k10's default depth

# The per-copy bound of a host-to-device copy (staging and the stream).
DEFAULT_STAGE_CHUNK_BYTES = 256 << 20


def _env_bytes(name: str) -> Optional[int]:
    """A positive integer from the environment, else None."""
    try:
        v = int(os.environ[name])
    except (KeyError, ValueError):
        return None
    return v if v > 0 else None


def stage_chunk_bytes(override: Optional[int] = None) -> int:
    """The per-copy bound: `override` (the --chunk-bytes flag) when
    positive, else TPU_REDUCTIONS_STAGE_CHUNK_BYTES, else 256 MiB."""
    if override is not None and override > 0:
        return int(override)
    return _env_bytes("TPU_REDUCTIONS_STAGE_CHUNK_BYTES") \
        or DEFAULT_STAGE_CHUNK_BYTES


def stage_threshold_bytes(override: Optional[int] = None) -> int:
    """The payload size above which staging goes in chunks: `override`
    when positive, else TPU_REDUCTIONS_STAGE_THRESHOLD_BYTES, else twice
    the effective chunk bound."""
    if override is not None and override > 0:
        return int(override)
    return _env_bytes("TPU_REDUCTIONS_STAGE_THRESHOLD_BYTES") \
        or 2 * stage_chunk_bytes()


# The serving engine's knobs (serve/engine.py), the JAX package's: the
# device-parallel shard threshold (one engine on one card never shards,
# serve/executor.capabilities) and the bound of the settled-response
# dedup cache.
DEFAULT_SHARD_THRESHOLD_BYTES = 512 << 20
DEFAULT_DEDUP_CACHE_SIZE = 1024


def shard_threshold_bytes(override: Optional[int] = None) -> int:
    """`override` when positive, else TPU_REDUCTIONS_SHARD_THRESHOLD_BYTES,
    else 512 MiB."""
    if override is not None and override > 0:
        return int(override)
    return _env_bytes("TPU_REDUCTIONS_SHARD_THRESHOLD_BYTES") \
        or DEFAULT_SHARD_THRESHOLD_BYTES


def dedup_cache_size(override: Optional[int] = None) -> int:
    """Entries of each engine's dedup cache: `override` when positive,
    else TPU_REDUCTIONS_DEDUP_CACHE_SIZE, else 1024 (LRU eviction)."""
    if override is not None and override > 0:
        return int(override)
    return _env_bytes("TPU_REDUCTIONS_DEDUP_CACHE_SIZE") \
        or DEFAULT_DEDUP_CACHE_SIZE


def _env_float(name: str) -> Optional[float]:
    """A non-negative float from the environment, else None."""
    try:
        v = float(os.environ[name])
    except (KeyError, ValueError):
        return None
    return v if v >= 0 else None


# The replica fleet's knobs (serve/autoscale.py, serve/journal.py), the
# JAX package's: the autoscaler's replica bounds and cooldown, and where
# the fleet journal persists.
DEFAULT_AUTOSCALE_MIN = 1
DEFAULT_AUTOSCALE_MAX = 8
DEFAULT_AUTOSCALE_COOLDOWN_S = 5.0


def autoscale_min(override: Optional[int] = None) -> int:
    """The fleet's floor: `override` when positive, else
    TPU_REDUCTIONS_AUTOSCALE_MIN, else 1."""
    if override is not None and override > 0:
        return int(override)
    return _env_bytes("TPU_REDUCTIONS_AUTOSCALE_MIN") \
        or DEFAULT_AUTOSCALE_MIN


def autoscale_max(override: Optional[int] = None) -> int:
    """The fleet's ceiling: `override` when positive, else
    TPU_REDUCTIONS_AUTOSCALE_MAX, else 8."""
    if override is not None and override > 0:
        return int(override)
    return _env_bytes("TPU_REDUCTIONS_AUTOSCALE_MAX") \
        or DEFAULT_AUTOSCALE_MAX


def autoscale_cooldown_s(override: Optional[float] = None) -> float:
    """Seconds between scaling actions: `override` when >= 0, else
    TPU_REDUCTIONS_AUTOSCALE_COOLDOWN_S, else 5."""
    if override is not None and override >= 0:
        return float(override)
    env = _env_float("TPU_REDUCTIONS_AUTOSCALE_COOLDOWN_S")
    return env if env is not None else DEFAULT_AUTOSCALE_COOLDOWN_S


def fleet_journal_path(override: Optional[str] = None) -> Optional[str]:
    """The fleet journal's file: `override` (the router's --journal),
    else TPU_REDUCTIONS_FLEET_JOURNAL, else None (journaling in memory)."""
    if override:
        return str(override)
    return os.environ.get("TPU_REDUCTIONS_FLEET_JOURNAL") or None


@dataclasses.dataclass
class ReduceConfig:
    """Single-chip reduction benchmark configuration (the driver's input)."""

    method: str = "SUM"
    dtype: str = "int32"
    n: int = 1 << 24
    threads: int = 256               # tile rows
    kernel: int = KERNEL_SINGLE_PASS
    max_blocks: int = 64             # partial-block clamp
    cpu_final: bool = False
    stream_buffers: int = STREAM_BUFFERS   # k10's depth; others ignore it
    cpu_thresh: int = 1
    backend: str = "auto"
    platform: str = "gpu"
    iterations: int = 100
    iterations_explicit: bool = False   # --iterations given (bounds a
                                        # chained shmoo's span)
    warmup: int = 1
    seed: int = 0
    device: Optional[int] = None     # --device index
    log_file: Optional[str] = "reduction.txt"
    master_log: Optional[str] = None
    qatest: bool = False
    verify: bool = True
    trace_dir: Optional[str] = None  # --trace: torch.profiler trace dir
    check: bool = False              # --check: the consistency gate
    timing: str = "periter"
    chain_reps: int = 5
    stat: str = "mean"
    f64: str = "native"              # --f64: float64's route (F64_ROUTES)
    stream: bool = False             # --stream: the streaming pipeline
    chunk_bytes: Optional[int] = None   # --chunk-bytes (stage_chunk_bytes)

    def __post_init__(self) -> None:
        self.method = self.method.upper()
        if self.method not in METHODS:
            raise ValueError(f"method must be one of {METHODS}, got {self.method!r}")
        if self.dtype not in DTYPE_ALIASES:
            raise ValueError(f"unknown dtype {self.dtype!r}")
        self.dtype = DTYPE_ALIASES[self.dtype]
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {self.backend!r}")
        if self.platform not in PLATFORMS:
            raise ValueError(f"platform must be one of {PLATFORMS}, got {self.platform!r}")
        if self.n <= 0:
            raise ValueError("n must be positive")
        if self.threads <= 0 or self.max_blocks <= 0:
            raise ValueError("threads/max_blocks must be positive")
        if self.stream_buffers <= 0:
            raise ValueError("stream_buffers must be positive")
        if self.timing not in TIMINGS:
            raise ValueError(f"timing must be periter|bulk|fetch|chained, "
                             f"got {self.timing!r}")
        if self.chain_reps <= 0:
            raise ValueError("chain_reps must be positive")
        if self.stat not in ("mean", "median"):
            raise ValueError(f"stat must be mean|median, got {self.stat!r}")
        if self.f64 not in F64_ROUTES:
            raise ValueError(f"f64 must be one of {F64_ROUTES}, got "
                             f"{self.f64!r}")
        if self.chunk_bytes is not None and self.chunk_bytes <= 0:
            raise ValueError("chunk_bytes must be positive")

    @property
    def nbytes(self) -> int:
        itemsize = {"int32": 4, "float32": 4, "float64": 8, "bfloat16": 2}
        return self.n * itemsize[self.dtype]


def build_single_chip_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu_reductions_torch",
        description="Self-verifying single-GPU reduction benchmark "
                    "(PyTorch + CUDA port of tpu_reductions)")
    p.add_argument("--method", type=str, default=None,
                   help="Reduction to benchmark: SUM|MIN|MAX (required)")
    p.add_argument("--type", dest="dtype", type=str, default="int",
                   help="int|float|double (or int32/float32/float64/bfloat16)")
    p.add_argument("--n", type=int, default=1 << 24,
                   help="Number of elements to reduce (default 2^24)")
    p.add_argument("--seed", type=int, default=0, help="Data seed")
    p.add_argument("--qatest", action="store_true",
                   help="QA batch mode: markers and log files only")
    p.add_argument("--no-verify", dest="verify", action="store_false",
                   help="Skip host-oracle verification")
    p.add_argument("--platform", type=str, default="gpu", choices=PLATFORMS,
                   help="gpu (default) or cpu, where the kernels' plain "
                        "PyTorch versions run")
    p.add_argument("--threads", type=int, default=256,
                   help="Tile rows (threads-per-block analog)")
    p.add_argument("--kernel", type=int, default=KERNEL_SINGLE_PASS,
                   help="6=single-pass fold accumulator, 7=two-pass "
                        "partials, 8=single-pass elementwise accumulator, "
                        "9=tensor-core SUM (float dtypes; other combos "
                        "WAIVE), 10=streamed elementwise accumulator; "
                        "0-5 WAIVED")
    p.add_argument("--maxblocks", dest="max_blocks", type=int, default=64,
                   help="Partial-block clamp (maxblocks analog)")
    p.add_argument("--streambuffers", dest="stream_buffers", type=int,
                   default=STREAM_BUFFERS,
                   help="Kernel-10 copy pipeline depth (default 4). Other "
                        "kernels ignore this knob")
    p.add_argument("--cpufinal", dest="cpu_final", action="store_true",
                   help="Finish the partial reduction on the host")
    p.add_argument("--cputhresh", dest="cpu_thresh", type=int, default=1,
                   help="Host-finish threshold on partial rows")
    p.add_argument("--backend", type=str, default="auto",
                   choices=list(BACKENDS))
    p.add_argument("--iterations", type=int, default=None,
                   help="Timed iterations (default 100)")
    p.add_argument("--warmup", type=int, default=1)
    p.add_argument("--device", type=int, default=None,
                   help="CUDA device index")
    p.add_argument("--shmoo", action="store_true",
                   help="Run the size sweep 2^shmoo-min..2^shmoo-max")
    p.add_argument("--shmoo-min", dest="shmoo_min", type=int, default=10,
                   help="Smallest shmoo size as a power of two (default 10)")
    p.add_argument("--shmoo-max", dest="shmoo_max", type=int, default=24,
                   help="Largest shmoo size as a power of two (default 24)")
    p.add_argument("--logfile", dest="log_file", type=str,
                   default="reduction.txt")
    p.add_argument("--masterlog", dest="master_log", type=str, default=None)
    p.add_argument("--trace", dest="trace_dir", type=str, default=None,
                   help="Write a torch.profiler trace of the timed call "
                        "into this directory")
    p.add_argument("--check", action="store_true",
                   help="Hold the kernel (at this row's --cpufinal, "
                        "--cputhresh and --streambuffers), its plain "
                        "version and the torch comparator against the host "
                        "oracle before the run; the row FAILS when one "
                        "disagrees")
    p.add_argument("--timing", type=str, default="periter", choices=TIMINGS,
                   help="periter=sync around every call; bulk=one synced "
                        "span; fetch=host round trip each call; chained="
                        "K data-dependent calls, slope-timed "
                        "(ops/chain.py)")
    p.add_argument("--chainreps", dest="chain_reps", type=int, default=5,
                   help="Slope repetitions for --timing=chained")
    p.add_argument("--stat", type=str, default="mean",
                   choices=("mean", "median"),
                   help="Per-iteration statistic feeding GB/s")
    p.add_argument("--f64", type=str, default="native", choices=F64_ROUTES,
                   help="float64's route: native (the card's f64, default) "
                        "or dd, the JAX package's route for f64 on a chip "
                        "without native f64 (two 32-bit planes through the "
                        "pair kernel). Other dtypes ignore it")
    p.add_argument("--stream", action="store_true",
                   help="Streaming pipeline (ops/stream.py): bounded chunks "
                        "copied to the card while the previous chunk is "
                        "folded; sustained-GB/s and chunks/s metrics")
    p.add_argument("--chunk-bytes", dest="chunk_bytes", type=int,
                   default=None,
                   help="Per-chunk bound of --stream (default: "
                        "TPU_REDUCTIONS_STAGE_CHUNK_BYTES, else 256 MiB)")
    return p


def parse_single_chip(argv=None):
    """Parse CLI args into (ReduceConfig, shmoo): shmoo is None, or with
    --shmoo the (min_pow, max_pow) size range. As in the JAX package, a
    missing or unknown --method or --type is a usage error (exit 2), as is
    a --shmoo range outside 0 < min <= max; a value ReduceConfig refuses
    exits 1 with its reason."""
    p = build_single_chip_parser()
    ns = p.parse_args(argv)
    if ns.method is None:
        p.error("--method={SUM|MIN|MAX} is required")
    if ns.dtype not in DTYPE_ALIASES:
        p.error(f"unknown --type {ns.dtype!r}; expected one of "
                f"{sorted(set(DTYPE_ALIASES))}")
    if ns.method.upper() not in METHODS:
        p.error(f"--method must be one of {METHODS}, got {ns.method!r}")
    try:
        cfg = ReduceConfig(
            method=ns.method, dtype=ns.dtype, n=ns.n, threads=ns.threads,
            kernel=ns.kernel, max_blocks=ns.max_blocks,
            stream_buffers=ns.stream_buffers, cpu_final=ns.cpu_final,
            cpu_thresh=ns.cpu_thresh,
            backend=ns.backend, platform=ns.platform,
            iterations=(ns.iterations if ns.iterations is not None
                        else 100),
            iterations_explicit=ns.iterations is not None,
            warmup=ns.warmup, seed=ns.seed,
            device=ns.device, log_file=ns.log_file,
            master_log=ns.master_log, qatest=ns.qatest, verify=ns.verify,
            trace_dir=ns.trace_dir, check=ns.check,
            timing=ns.timing, chain_reps=ns.chain_reps, stat=ns.stat,
            f64=ns.f64, stream=ns.stream, chunk_bytes=ns.chunk_bytes)
    except ValueError as e:
        p.exit(1, f"{p.prog}: error: {e}\n")
    if ns.shmoo and not 0 < ns.shmoo_min <= ns.shmoo_max:
        p.error(f"--shmoo-min/--shmoo-max must satisfy 0 < min <= max, "
                f"got {ns.shmoo_min}/{ns.shmoo_max}")
    return cfg, ((ns.shmoo_min, ns.shmoo_max) if ns.shmoo else None)


@dataclasses.dataclass
class CollectiveConfig:
    """Cross-rank collective reduction configuration (the MPI_Reduce
    analog; the JAX package's CollectiveConfig, whose fields and defaults
    it keeps), plus the port's `platform` and `f64`:

      n            total elements over all ranks (NUM_INTS/NUM_DOUBLES,
                   constants.h:1-2, as a flag)
      retries      timed repetitions (RETRY_COUNT=5, constants.h:5)
      num_devices  rank count (the sbatch --nodes sweep); the processes
                   hold them in contiguous blocks, twice that many
                   virtual ranks under mode='co' (provisioned_ranks)
      mesh_shape   optional multi-axis mesh whose first axis is the ranks
      mapping      rank placement over processes (BGLMPI_MAPPING)
      mode         'vn' every virtual rank, 'co' every other one
      rooted       'none' all-reduce; 'scatter' reduce-scatter; 'root'
                   reduce-to-root (reduce.c:76,90). Bools accepted.
      quantized    the block-quantized wire (collectives/quant.py) at
                   quant_bits; an unsupported (method, dtype, bits) is
                   refused with the JAX package's words
      platform     gpu (the card, default) or cpu
      f64          float64's route: native, or dd, the JAX package's
                   pair planes (also TPU_REDUCTIONS_FORCE_DD=1)
    """

    method: str = "SUM"
    dtype: str = "int32"
    n: int = 1 << 24
    retries: int = 5
    warmup: int = 1                  # reduce.c:61-64 warm-up reduce
    num_devices: Optional[int] = None
    mesh_shape: Optional[tuple] = None
    mapping: str = "default"
    mode: str = "vn"
    rooted: str = "none"             # none|scatter|root (bools accepted)
    quantized: bool = False
    quant_bits: int = 8
    seed: int = 0
    verify: bool = True
    qatest: bool = False             # batch mode: QA markers only
    timing: str = "periter"          # periter | chained (one CUDA graph)
    chain_span: int = 16             # iterations per slope
    coordinator: Optional[str] = None   # process 0's host:port
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    out: Optional[str] = None        # --out artifact (bench/resume)
    platform: str = "gpu"
    f64: str = "native"

    def __post_init__(self) -> None:
        self.method = self.method.upper()
        if self.method not in METHODS:
            raise ValueError(f"method must be one of {METHODS}, got {self.method!r}")
        self.dtype = DTYPE_ALIASES[self.dtype]
        from tpu_reductions_torch.collectives.algorithms import \
            normalize_rooted
        self.rooted = normalize_rooted(self.rooted)
        if self.mode not in ("vn", "co"):
            raise ValueError("mode must be 'vn' or 'co'")
        if self.timing not in ("periter", "chained"):
            raise ValueError(f"timing must be periter|chained, "
                             f"got {self.timing!r}")
        if self.chain_span <= 0:
            raise ValueError("chain_span must be positive")
        if self.platform not in PLATFORMS:
            raise ValueError(f"platform must be one of {PLATFORMS}, got {self.platform!r}")
        if self.f64 not in F64_ROUTES:
            raise ValueError(f"f64 must be one of {F64_ROUTES}, got "
                             f"{self.f64!r}")
        if self.quantized:
            from tpu_reductions_torch.collectives.quant import (
                quant_support_error, quant_supported)
            if not quant_supported(self.method, self.dtype,
                                   self.quant_bits):
                raise ValueError(quant_support_error(
                    self.method, self.dtype, self.quant_bits))

    @property
    def provisioned_ranks(self) -> Optional[int]:
        """The virtual ranks this process provides: --devices, twice that
        under mode='co' (the JAX CLI's virtual CPU devices), in one
        process; across processes its block of them
        (parallel/mesh.placement: contiguous blocks in process order,
        none where the ranks are fewer than the processes); None without
        --devices (the platform's device count)."""
        if self.num_devices is None:
            return None
        want = self.num_devices * (2 if self.mode == "co" else 1)
        nproc = self.num_processes or 1
        if nproc == 1:
            return want
        from tpu_reductions_torch.device import rank_blocks
        blocks = rank_blocks(want, nproc)
        me = self.process_id or 0
        return len(blocks[me]) if me < len(blocks) else 0


def build_collective_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu_reductions_torch.collective",
        description="Cross-rank collective reduction benchmark "
                    "(reference: mpi/reduce.c over the BG/L torus), its "
                    "ranks the rows of one tensor on the card",
        # no prefix abbreviation: an abbreviated --hel would reach the
        # parser as --help after the RUNNING marker printed
        allow_abbrev=False,
    )
    p.add_argument("--method", type=str, default=None,
                   help="Reduction to benchmark: SUM|MIN|MAX (required)")
    p.add_argument("--type", dest="dtype", type=str, default="int",
                   help="int|float|double (or int32/float32/float64/bfloat16)")
    p.add_argument("--n", type=int, default=1 << 24,
                   help="Number of elements to reduce (default 2^24)")
    p.add_argument("--seed", type=int, default=0, help="Data seed")
    p.add_argument("--qatest", action="store_true",
                   help="QA batch mode: markers only")
    p.add_argument("--no-verify", dest="verify", action="store_false",
                   help="Skip host-oracle verification")
    p.add_argument("--platform", type=str, default="gpu", choices=PLATFORMS,
                   help="gpu (default): the ranks are rows on the card; "
                        "cpu: on the host, and across processes over gloo")
    p.add_argument("--retries", type=int, default=5,
                   help="Timed repetitions (RETRY_COUNT analog)")
    p.add_argument("--warmup", type=int, default=1)
    p.add_argument("--devices", dest="num_devices", type=int, default=None,
                   help="Device count (rank-count analog): virtual ranks, "
                        "in contiguous blocks over --num-processes")
    p.add_argument("--mapping", type=str, default="default",
                   help="Mesh axis ordering (BGLMPI_MAPPING analog)")
    p.add_argument("--mode", type=str, default="vn", choices=("vn", "co"),
                   help="vn=all devices, co=one per chip (BG/L VN/CO analog)")
    p.add_argument("--quantized", action="store_true",
                   help="block-quantized ring wire (EQuARX-style): SUM "
                        "over float/bfloat16/double within a declared "
                        "bound, MIN/MAX over float/double exact; float64 "
                        "rides the dd planes")
    p.add_argument("--quant-bits", dest="quant_bits", type=int, default=8,
                   help="wire width for --quantized: 4|8|16 for SUM "
                        "block scaling, 8|16 for MIN/MAX coarse keys "
                        "(default 8)")
    p.add_argument("--rooted", nargs="?", const="scatter", default="none",
                   choices=("none", "scatter", "root"),
                   help="Rooted reduce semantics: bare --rooted = "
                        "'scatter' (reduce-scatter, the rooted wire "
                        "cost); 'root' = true reduce-to-root like "
                        "MPI_Reduce(root=0) — the root rank holds the "
                        "full reduced array (reduce.c:76,90)")
    p.add_argument("--timing", type=str, default="periter",
                   choices=("periter", "chained"),
                   help="periter = reduce.c's sync-per-collective "
                        "structure; chained = data-dependent iterations, "
                        "slope-timed, one CUDA graph a trip on the card")
    p.add_argument("--chainspan", dest="chain_span", type=int, default=16,
                   help="Iterations per slope for --timing=chained")
    p.add_argument("--coordinator", type=str, default=None,
                   help="Multi-process: process 0's address host:port")
    p.add_argument("--num-processes", dest="num_processes", type=int,
                   default=None,
                   help="Multi-process: total participating processes "
                        "(--platform=cpu only: gloo)")
    p.add_argument("--process-id", dest="process_id", type=int,
                   default=None,
                   help="Multi-process: this process's id in [0, "
                        "num_processes)")
    p.add_argument("--out", type=str, default=None,
                   help="JSON artifact path (bench/resume.Checkpoint: "
                        "rows persisted the moment they land; an "
                        "interrupted run resumes them)")
    p.add_argument("--f64", type=str, default="native", choices=F64_ROUTES,
                   help="float64's route: native (the card's f64, default) "
                        "or dd, the JAX package's pair planes (dd ring for "
                        "SUM, order-key pairs for MIN/MAX). Other dtypes "
                        "ignore it")
    return p


def parse_collective(argv=None, *, blocks: bool = False
                     ) -> CollectiveConfig:
    """Parse the collective CLI. A missing --method is a usage error
    (exit 2); a value CollectiveConfig refuses raises ValueError.

    On the card --devices need not divide among --num-processes: the
    processes hold the ranks in contiguous blocks
    (parallel/mesh.placement), as JAX's device path takes the first k
    devices of the group. On --platform=cpu the CLI refuses such a count
    with the JAX CLI's words and exit 1 (tpu_reductions/config.py:556-568,
    where each process provisions an equal share of virtual CPU devices);
    `blocks` keeps the block placement there too, for the workers of
    bench/multicard.py, which place a ladder's rungs on the processes."""
    p = build_collective_parser()
    ns = p.parse_args(argv)
    if ns.method is None:
        p.error("--method={SUM|MIN|MAX} is required")
    nproc = ns.num_processes or 1
    if ns.platform == "cpu" and ns.num_devices and nproc > 1 \
            and not blocks:
        want = ns.num_devices * (2 if ns.mode == "co" else 1)
        if want % nproc != 0:
            co = (" (mode=co provisions 2x that in virtual devices)"
                  if want != ns.num_devices else "")
            raise SystemExit(
                f"--devices={ns.num_devices}{co} must divide evenly among "
                f"--num-processes={nproc}: every process provisions an "
                "equal local share (docs/MULTIHOST.md)")
    return CollectiveConfig(
        method=ns.method, dtype=ns.dtype, n=ns.n, retries=ns.retries,
        warmup=ns.warmup, num_devices=ns.num_devices, mapping=ns.mapping,
        mode=ns.mode, rooted=ns.rooted, seed=ns.seed, verify=ns.verify,
        qatest=ns.qatest, timing=ns.timing, chain_span=ns.chain_span,
        quantized=ns.quantized, quant_bits=ns.quant_bits,
        coordinator=ns.coordinator, num_processes=ns.num_processes,
        process_id=ns.process_id, out=ns.out, platform=ns.platform,
        f64=ns.f64,
    )
