"""The card's cold costs: the kernels' build, and each surface's first
call against a warm one.

The counterpart of tpu_reductions/bench/warm.py:1, the JAX package's
compile observatory, mapped onto what is cold on the card:

  nvcc      the build of every kernel source (ops/_cuda.build) into an
            empty directory (cold), and again into the now full one
            (warm: nothing is stale, nothing is compiled);
  surfaces  for each surface of `surfaces()` (the JAX registry's ids),
            its first call in this process (cold: the library's load,
            the plans' queries, the eager warm-up step and the capture
            of the chain's CUDA graph) against a second call (warm: the
            graph's replay).

The manifest has the JAX rows' keys (`surface`, `platform`, `verdict`,
`dur_s`, `lower_s`, `compile_s`, `count`) in the JAX artifact's
shape (`{"kind": "compile-observatory", "version": 1, "complete": ...,
"surfaces": [...]}`): at most one cold and one warm row per surface and
platform, written through obs/compile.CompileLedger, the file's one
writer. There is no lowering: `lower_s` is null, and `compile_s` is
nvcc's seconds on the build rows. The pass emits `warm.start`, a
`warm.surface` a surface and `warm.end`, as in JAX. On the CPU (`--platform=cpu`) there is no build and the chain is
the eager loop, so the rows time the plain versions' first calls.

A surface that fails is reported and the pass goes on. An artifact left
`complete: false` by an interrupted pass keeps its surfaces, which are
not probed again; a complete one is probed afresh.

CLI:
    python -m tpu_reductions_torch.bench.warm [--platform=cpu] \\
        [--n=1048576] [--only=k6,dd] [--out=out/compile_ledger.json]

Exit 0 when at least one surface was probed, else 1.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from typing import Callable, List, Optional, Tuple

import torch

from tpu_reductions_torch import device as device_mod
from tpu_reductions_torch.config import (KERNEL_ELEMENTWISE, KERNEL_MXU,
                                         KERNEL_STREAM, KERNEL_TWO_PASS,
                                         PLATFORMS)
from tpu_reductions_torch.obs import ledger
from tpu_reductions_torch.obs.compile import CompileLedger
from tpu_reductions_torch.utils.staging import stage_flat

BUILD_SURFACE = "nvcc"

# a surface: (id, build(n, device) -> (fn, args)); one call is fn(*args)
Surface = Tuple[str, Callable]


def _kernel_surface(surface: str, kernel: int, dtype: str, threads: int,
                    depth: int) -> Surface:
    """A kernel's chained SUM, staged as the races stage it."""
    def build(n, device):
        from tpu_reductions_torch.ops.chain import make_chained_reduce
        from tpu_reductions_torch.ops.kernel_reduce import make_staged_core
        from tpu_reductions_torch.utils.rng import host_data
        op, stage_fn, core = make_staged_core(
            "SUM", n, dtype, threads=threads, kernel=kernel,
            stream_buffers=depth, device=device)
        return make_chained_reduce(core, op), (stage_fn(host_data(n, dtype)),
                                               2)
    return surface, build


def _torch_surface() -> Surface:
    """The torch comparator's chain (`--backend=torch`; JAX id `xla`)."""
    def build(n, device):
        from tpu_reductions_torch.ops.chain import make_chained_reduce
        from tpu_reductions_torch.ops.registry import get_op
        from tpu_reductions_torch.utils.rng import host_data
        op = get_op("SUM")
        x2d = stage_flat(host_data(n, "int32"), device).reshape(-1, 128)
        return make_chained_reduce(op.reduce, op), (x2d, 2)
    return "torch", build


def _dd_surface() -> Surface:
    """The f64 pair route's chain (SUM)."""
    def build(n, device):
        from tpu_reductions_torch.ops.chain import make_chained_reduce
        from tpu_reductions_torch.ops.dd_reduce import make_dd_device_reduce
        from tpu_reductions_torch.ops.registry import get_op
        from tpu_reductions_torch.utils.rng import host_data
        stage, core, _finish = make_dd_device_reduce("SUM", n, device=device)
        hi2d, lo2d, _scale = stage(host_data(n, "float64").numpy())
        return make_chained_reduce(core, get_op("SUM")), ((hi2d, lo2d), 2)
    return "dd", build


def _stream_surface() -> Surface:
    """The streaming pipeline over four chunks (ops/stream.py)."""
    def build(n, device):
        from tpu_reductions_torch.ops.stream import run_stream
        from tpu_reductions_torch.utils.rng import host_data
        flat = host_data(n, "int32")
        return (lambda: run_stream(flat, "SUM", chunk_bytes=n, device=device)
                .value), ()
    return "stream", build


def _serve_surface() -> Surface:
    """The serving engine's batch-1 bucket: one torch reduction along dim
    1 of a (1, n) int32 stack on the device (serve/executor.py; what
    engine.prewarm calls first)."""
    def build(n, device):
        from tpu_reductions_torch.ops.registry import get_op
        from tpu_reductions_torch.utils.rng import host_data
        x = stage_flat(host_data(n, "int32").reshape(1, n), device)
        return (lambda: get_op("SUM").reduce_dim(x, 1)), ()
    return "serve-bucket/sum", build


def _family_surface(surface: str, method: str, dtype: str,
                    impl: str) -> Surface:
    """A family cell's chained digest (bench/family_spot.py)."""
    def build(n, device):
        from tpu_reductions_torch.bench.family_spot import _cell_fns
        from tpu_reductions_torch.ops.chain import make_chained_reduce
        from tpu_reductions_torch.ops.registry import get_op
        from tpu_reductions_torch.utils.rng import host_data
        x = stage_flat(host_data(n, dtype), device)
        _full, core, _offsets = _cell_fns(method, dtype, impl, x, 64, 0)
        return (make_chained_reduce(core, get_op(method)),
                (x.reshape(-1, 128), 2))
    return surface, build


def surfaces() -> List[Surface]:
    """The registry: smoke's geometries and the chains, the stream and
    the family surfaces smoke does not build, under the JAX ids.
    The counterpart of tpu_reductions/bench/warm.py:198."""
    return [
        _kernel_surface("k6", 6, "int32", 256, 4),
        _kernel_surface("k7", KERNEL_TWO_PASS, "int32", 384, 4),
        _kernel_surface("k8", KERNEL_ELEMENTWISE, "int32", 2048, 4),
        _kernel_surface("k9", KERNEL_MXU, "float32", 256, 4),
        _kernel_surface("k10@2", KERNEL_STREAM, "int32", 512, 2),
        _kernel_surface("k10@4", KERNEL_STREAM, "int32", 512, 4),
        _kernel_surface("k10@8", KERNEL_STREAM, "int32", 512, 8),
        _dd_surface(),
        _torch_surface(),
        _stream_surface(),
        _serve_surface(),
        _family_surface("mxu-scan", "SCAN", "float32", "mxu-scan"),
        _family_surface("xla-cumsum", "SCAN", "int32", "xla-cumsum"),
        _family_surface("seg/segsum", "SEGSUM", "int32", "seg"),
        _family_surface("argk/argmin", "ARGMIN", "float32", "argk"),
    ]


def _row(surface: str, platform: str, verdict: str, dur_s: float,
         compile_s: Optional[float] = None) -> dict:
    return {"surface": surface, "platform": platform, "verdict": verdict,
            "dur_s": round(dur_s, 6), "lower_s": None,
            "compile_s": None if compile_s is None else round(compile_s, 6)}


def _timed_call(fn, args, device) -> float:
    """Seconds of one call, to the device's end of its work."""
    # redlint: disable=RED002 -- warm's cold and warm first-call seconds are the compile observatory's observation, host seconds to the card's end by definition
    t0 = time.perf_counter()
    out = fn(*args)
    device_mod.synchronize(device)
    if isinstance(out, torch.Tensor):
        out.cpu()
    # redlint: disable=RED002 -- closes the first-call window of the line above
    return time.perf_counter() - t0


def build_rows(scratch: str, platform: str) -> List[dict]:
    """The cold and the warm build into `scratch` (empty at first).
    They stand where the compile cache's rows stand in
    tpu_reductions/bench/warm.py:228."""
    from tpu_reductions_torch.ops import _cuda
    rows = []
    for verdict in ("cold", "warm"):
        seconds, _log = _cuda.build(scratch)
        rows.append(_row(BUILD_SURFACE, platform, verdict, seconds, seconds))
    return rows


def run_warm(n: int = 1 << 20, platform: str = "gpu",
             skip: Optional[set] = None, only: Optional[set] = None,
             log=print) -> List[dict]:
    """Each surface's cold and warm call (module docstring): its rows, or
    one failed row. `skip` names surfaces an interrupted pass already
    holds; `only` restricts the registry.
    The counterpart of tpu_reductions/bench/warm.py:228."""
    device = device_mod.resolve(platform)
    rows: List[dict] = []
    active = [(s, b) for s, b in surfaces() if only is None or s in only]
    ledger.emit("warm.start", surfaces=len(active))
    for surface, build in active:
        if skip and surface in skip:
            rows.append({"surface": surface, "verdict": "resumed",
                         "error": None})
            log(f"  warm {surface:<16} resumed (held by the interrupted "
                "pass)")
            continue
        try:
            fn, args = build(n, device)
            cold = _timed_call(fn, args, device)
            warm = _timed_call(fn, args, device)
            if hasattr(fn, "close"):
                fn.close()
        except Exception as e:   # the report is the product
            rows.append({"surface": surface, "platform": platform,
                         "verdict": "failed",
                         "error": f"{type(e).__name__}: {e}"[:300]})
            ledger.emit("warm.surface", surface=surface, verdict="failed",
                        error=rows[-1]["error"])
            log(f"  warm {surface:<16} failed  {rows[-1]['error']}")
            continue
        rows += [_row(surface, platform, "cold", cold),
                 _row(surface, platform, "warm", warm)]
        ledger.emit("warm.surface", surface=surface, verdict="cold",
                    error=None)
        log(f"  warm {surface:<16} first call {cold:.4f}s, warm call "
            f"{warm:.4f}s")
    ledger.emit("warm.end",
                cold=sum(1 for r in rows if r.get("verdict") == "cold"),
                warm=sum(1 for r in rows if r.get("verdict") == "warm"),
                failed=sum(1 for r in rows if r.get("error")))
    return rows


def main(argv=None) -> int:
    """CLI: the build's and every surface's cold against warm cost.
    The counterpart of tpu_reductions/bench/warm.py:277."""
    p = argparse.ArgumentParser(
        prog="tpu_reductions_torch.bench.warm",
        description="Time the kernels' build cold and warm, and each "
                    "surface's first call against a warm one; write the "
                    "manifest")
    p.add_argument("--n", type=int, default=1 << 20,
                   help="Elements per surface")
    p.add_argument("--platform", type=str, default="gpu", choices=PLATFORMS)
    p.add_argument("--out", type=str, default="out/compile_ledger.json",
                   help="Manifest (resumable: an interrupted pass keeps "
                        "its surfaces)")
    p.add_argument("--only", type=str, default=None,
                   help="Comma-separated surface ids to restrict to")
    ns = p.parse_args(argv)
    from tpu_reductions_torch.exec.core import maybe_arm
    from tpu_reductions_torch.obs.ledger import arm_session
    arm_session("bench.warm", argv=list(argv) if argv else sys.argv[1:])
    maybe_arm(ns.platform)
    if ns.n <= 0:
        p.error("--n must be positive")
    # k10's deepest case needs threads*128*depth elements in flight
    if ns.n < 512 * 128 * 8:
        p.error(f"--n must be >= {512 * 128 * 8} so the deepest k10 "
                "pipeline has a full working set")
    out_dir = os.path.dirname(os.path.abspath(ns.out))
    os.makedirs(out_dir, exist_ok=True)
    manifest = CompileLedger(ns.out)
    skip = ({r["surface"] for r in manifest.rows}
            if manifest.prior_complete is False else set())
    only = ({s.strip() for s in ns.only.split(",") if s.strip()}
            if ns.only else None)
    log = (lambda m: print(m, file=sys.stderr))

    rows: List[dict] = []
    if ns.platform == "gpu" and BUILD_SURFACE not in skip \
            and (only is None or BUILD_SURFACE in only):
        with tempfile.TemporaryDirectory(dir=out_dir) as scratch:
            try:
                built = build_rows(scratch, ns.platform)
            except (RuntimeError, OSError) as e:
                built = [{"surface": BUILD_SURFACE, "platform": ns.platform,
                          "verdict": "failed",
                          "error": f"{type(e).__name__}: {e}"[:300]}]
        for row in built:
            log(f"  warm {BUILD_SURFACE:<16} {row['verdict']:<7} "
                f"{row.get('dur_s')}s")
        rows += built
    rows += run_warm(n=ns.n, platform=ns.platform, skip=skip, only=only,
                     log=log)
    for row in rows:
        if row["verdict"] in ("cold", "warm"):
            manifest.record(row)
    failed = sorted({r["surface"] for r in rows if r.get("error")})
    probed = sorted({r["surface"] for r in rows
                     if r["verdict"] in ("cold", "resumed")})
    print(f"warm: {len(probed)}/{len(probed) + len(failed)} surface(s) "
          "timed cold and warm"
          + (f"; FAILED: {', '.join(failed)}" if failed else ""))
    manifest.finalize()
    print(f"wrote {ns.out}")
    return 0 if probed else 1


if __name__ == "__main__":
    # redlint: disable=RED019 -- warm is the compile observatory's pass: each surface's cold and warm first call is the observation itself, not a launch plan; the watchdog is armed in main
    sys.exit(main())
