"""The task registry: the measurement units a window of card time is
spent on.

The counterpart of tpu_reductions/sched/tasks.py. `SESSION_TASKS` keeps
the JAX registry's slugs, values, budgets, `requires`, `hazard` and
compile-observatory `surfaces` (the comparator's surface is `torch`
where JAX's is `xla`), with the port's instruments as commands: every
command is a `python -m tpu_reductions_torch...` CLI writing under
`out/`, never bench.py or scripts/*.sh. The headline bench is
bench.round, the serving scale, elastic and recovery tasks are
serve.loadgen with the flags the JAX package's scripts pass, and the
flagship is bench.experiment. Each task's `rehearsal_command` is its
`--platform=cpu` form at a small n (`registry(platform="cpu")` swaps it
in); chip-only tasks drop out of a rehearsal and are recorded skipped.

A task's completion predicate reads the bench/resume artifact contract:
an artifact with `complete: true` written in this window (mtime >= the
plan state's window_t0) means the unit's evidence already landed.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class Task:
    """One schedulable measurement unit."""
    name: str                       # slug: plan-state / ledger identity
    title: str                      # display name
    value: float                    # window-value score
    budget_s: float                 # wall-clock cap and cold-start prior
    command: str                    # bash -c body
    artifacts: Tuple[str, ...]      # what the task writes
    done_artifact: Optional[str] = None   # complete:true here => skip
    hazard: bool = False            # 4 GiB cells: strictly last
    chip_only: bool = False         # excluded from cpu rehearsal plans
    requires: Tuple[str, ...] = ()  # must be attempted first
    rehearsal_command: Optional[str] = None   # cpu-scale variant
    surfaces: Tuple[str, ...] = ()  # compile-observatory surface ids
    #                                 its kernels hit (obs/compile.py):
    #                                 all warm => the cheaper prior


def artifact_complete(path: str, window_t0: float) -> bool:
    """The completion predicate: `path` parses, carries
    `complete: true`, and was written this window (mtime >= window_t0;
    a complete artifact of an earlier window does not suppress this
    window's rows)."""
    try:
        if os.path.getmtime(path) < window_t0:
            return False
        data = json.loads(open(path).read())
    except (OSError, ValueError):
        return False
    return isinstance(data, dict) and data.get("complete") is True


_M = "python -m tpu_reductions_torch"

_INT_OP_CMD = (
    "rc=0; "
    f"{_M}.bench.spot --type=int --methods=SUM,MIN,MAX --n=16777216 "
    "--kernel=7 --threads=384 --iterations=256 --chainreps=5 "
    "--out=out/int_op_spot_k7.json || rc=$?; "
    f"{_M}.bench.spot --type=int --methods=SUM,MIN,MAX --n=16777216 "
    "--kernel=6 --threads=512 --iterations=256 --chainreps=5 "
    "--out=out/int_op_spot_k6.json || rc=$?; "
    f"{_M}.bench.spot --type=int --methods=SUM,MIN,MAX --n=16777216 "
    "--backend=torch --iterations=256 --chainreps=5 "
    "--out=out/int_op_spot_torch.json || rc=$?; "
    "exit $rc")

_MXU_F32_CMD = (
    "rc=0; "
    f"{_M}.bench.autotune --method=SUM --type=float --n=16777216 "
    "--iterations=256 --grid=mxu --comparator "
    "--out=out/tune_mxu_f32.json || rc=$?; "
    f"{_M}.bench.autotune --method=SUM --type=float --n=67108864 "
    "--grid=mxu --comparator --out=out/tune_mxu_f32_hbm.json || rc=$?; "
    "exit $rc")

# the rehearsal scale: small n and few reps, on the CPU
_R = "--platform=cpu --n=65536 --iterations=16 --chainreps=2"

SESSION_TASKS: Tuple[Task, ...] = (
    Task("firstrow", "first row", value=1000.0, budget_s=300,
         command=f"{_M}.bench.firstrow --out=out/FIRSTROW.json",
         rehearsal_command=(f"{_M}.bench.firstrow {_R} --skip-doubles "
                            "--out=out/FIRSTROW.json"),
         artifacts=("out/FIRSTROW.json", "out/FIRSTROW.json.doubles.json"),
         done_artifact="out/FIRSTROW.json", surfaces=("k7", "dd")),
    Task("headline_bench", "headline bench", value=400.0, budget_s=240,
         command=f"{_M}.bench.round --out=out/round",
         artifacts=("out/round",),
         chip_only=True,   # the round metric is the card's number
         requires=("firstrow",), surfaces=("k7", "dd")),
    Task("double_spot", "double scoreboard", value=360.0, budget_s=300,
         command=(f"{_M}.bench.spot --type=double --methods=SUM,MIN,MAX "
                  "--n=16777216 --iterations=256 --chainreps=5 "
                  "--out=out/double_spot.json"),
         rehearsal_command=(f"{_M}.bench.spot --type=double "
                            f"--methods=SUM,MIN,MAX {_R} "
                            "--out=out/double_spot.json"),
         artifacts=("out/double_spot.json",),
         done_artifact="out/double_spot.json", surfaces=("dd",)),
    Task("calibrate_ladder", "calibration ladder", value=260.0,
         budget_s=240,
         command=(f"{_M}.utils.calibrate --ladder --chainspan 256 "
                  "--reps 7 --out=out/calibration_live.json"),
         rehearsal_command=(f"{_M}.utils.calibrate --ladder "
                            "--platform=cpu --n=65536 --chainspan 16 "
                            "--reps 2 --out=out/calibration_live.json"),
         artifacts=("out/calibration_live.json",),
         done_artifact="out/calibration_live.json", surfaces=("torch",)),
    Task("smoke", "kernel smoke", value=240.0, budget_s=420,
         command=f"{_M}.bench.smoke --out=out/smoke.json",
         rehearsal_command=(f"{_M}.bench.smoke --platform=cpu "
                            "--out=out/smoke.json"),
         artifacts=("out/smoke.json",), done_artifact="out/smoke.json",
         surfaces=("k8", "k9", "k10@2", "k10@4", "k10@8", "dd")),
    Task("hbm26", "hbm regime race 2^26", value=200.0, budget_s=420,
         command=(f"{_M}.bench.autotune --method=SUM --type=int "
                  "--n=67108864 --grid=hbm --comparator "
                  "--out=out/tune_hbm.json"),
         artifacts=("out/tune_hbm.json",),
         done_artifact="out/tune_hbm.json",
         chip_only=True, requires=("smoke",),
         surfaces=("k8", "k10@2", "k10@4", "k10@8")),
    Task("hbm27", "hbm regime race 2^27", value=180.0, budget_s=420,
         command=(f"{_M}.bench.autotune --method=SUM --type=int "
                  "--n=134217728 --grid=hbm --comparator "
                  "--out=out/tune_hbm27.json"),
         artifacts=("out/tune_hbm27.json",),
         done_artifact="out/tune_hbm27.json",
         chip_only=True, requires=("smoke",),
         surfaces=("k8", "k10@2", "k10@4", "k10@8")),
    Task("int_op_parity", "int op parity probe", value=160.0,
         budget_s=420, command=_INT_OP_CMD,
         artifacts=("out/int_op_spot_k7.json", "out/int_op_spot_k6.json",
                    "out/int_op_spot_torch.json"),
         done_artifact="out/int_op_spot_torch.json",
         chip_only=True, requires=("smoke",),
         surfaces=("k6", "k7", "torch")),
    Task("stream_probe", "streaming pipeline probe", value=170.0,
         budget_s=300,
         command=(f"{_M}.bench.stream --method=SUM --type=int "
                  "--n=268435456 --chunk-bytes=67108864 --sync-every=4 "
                  "--out=out/stream_probe.json"),
         rehearsal_command=(f"{_M}.bench.stream --method=SUM --type=int "
                            "--platform=cpu --n=1048576 "
                            "--chunk-bytes=65536 --sync-every=4 "
                            "--serial-baseline "
                            "--out=out/stream_probe.json"),
         artifacts=("out/stream_probe.json",),
         done_artifact="out/stream_probe.json", surfaces=("stream",)),
    Task("bf16_spot", "bf16 existence spot", value=150.0, budget_s=180,
         command=(f"{_M}.bench.spot --type=bfloat16 --methods=SUM,MIN,MAX "
                  "--n=16777216 --iterations=256 --chainreps=5 "
                  "--out=out/bf16_spot.json"),
         rehearsal_command=(f"{_M}.bench.spot --type=bfloat16 "
                            f"--methods=SUM,MIN,MAX {_R} "
                            "--out=out/bf16_spot.json"),
         artifacts=("out/bf16_spot.json",),
         done_artifact="out/bf16_spot.json", surfaces=("k6",)),
    Task("mxu_f32", "mxu race f32", value=120.0, budget_s=420,
         command=_MXU_F32_CMD,
         artifacts=("out/tune_mxu_f32.json", "out/tune_mxu_f32_hbm.json"),
         done_artifact="out/tune_mxu_f32_hbm.json",
         chip_only=True, requires=("smoke",), surfaces=("k9",)),
    Task("mxu_bf16", "mxu race bf16", value=100.0, budget_s=300,
         command=(f"{_M}.bench.autotune --method=SUM --type=bfloat16 "
                  "--n=16777216 --iterations=256 --grid=mxu --comparator "
                  "--out=out/tune_mxu_bf16.json"),
         artifacts=("out/tune_mxu_bf16.json",),
         done_artifact="out/tune_mxu_bf16.json",
         chip_only=True, requires=("smoke",), surfaces=("k9",)),
    Task("fine_race", "fine tile race", value=90.0, budget_s=420,
         command=(f"{_M}.bench.autotune --method=SUM --type=int "
                  "--n=16777216 --iterations=256 --chainreps=7 "
                  "--grid=fine --out=out/tune_fine.json"),
         rehearsal_command=(f"{_M}.bench.autotune --method=SUM --type=int "
                            "--platform=cpu --n=65536 --iterations=16 "
                            "--chainreps=2 --grid=fine "
                            "--out=out/tune_fine.json"),
         artifacts=("out/tune_fine.json",),
         done_artifact="out/tune_fine.json",
         requires=("smoke",), surfaces=("k6", "k7", "k8")),
    Task("quant_curve", "accuracy-vs-bandwidth curve", value=140.0,
         budget_s=300,
         command=f"{_M}.bench.quant_curve --out=out/quant_curve.json",
         rehearsal_command=(f"{_M}.bench.quant_curve --platform=cpu "
                            "--ranks=2,4,8 --n=65536 "
                            "--out=out/quant_curve.json"),
         artifacts=("out/quant_curve.json",),
         done_artifact="out/quant_curve.json"),
    Task("reshard_curve", "redistribution curve", value=120.0,
         budget_s=420,
         command=f"{_M}.bench.reshard_curve --out=out/reshard_curve.json",
         rehearsal_command=(f"{_M}.bench.reshard_curve --platform=cpu "
                            "--ranks=2,4 --n=65536 --rows=64 "
                            "--out=out/reshard_curve.json"),
         artifacts=("out/reshard_curve.json",),
         done_artifact="out/reshard_curve.json"),
    Task("serving_scale", "open-loop serving scale curve", value=110.0,
         budget_s=600,
         command=(f"{_M}.serve.loadgen --devices=8 --scale "
                  "--scale-clients=64,256,1024 --replicas=4 --seed=0 "
                  "--out=out/serving_scale.json"),
         rehearsal_command=(f"{_M}.serve.loadgen --platform=cpu "
                            "--devices=8 --scale --scale-clients=16,64 "
                            "--replicas=2 --n=8192 --skip-sharded "
                            "--out=out/serving_scale.json"),
         artifacts=("out/serving_scale.json",),
         done_artifact="out/serving_scale.json"),
    Task("serving_elastic", "elastic autoscaler curve", value=105.0,
         budget_s=600,
         command=(f"{_M}.serve.loadgen --devices=8 --elastic "
                  "--plan=diurnal --scale-clients=64,256,1024 --seed=0 "
                  "--out=out/serving_elastic.json"),
         rehearsal_command=(f"{_M}.serve.loadgen --platform=cpu "
                            "--devices=8 --elastic --scale-clients=64 "
                            "--elastic-seconds=4 --n=8192 "
                            "--out=out/serving_elastic.json"),
         artifacts=("out/serving_elastic.json",),
         done_artifact="out/serving_elastic.json"),
    Task("family_spot", "reduction-family spot", value=130.0,
         budget_s=300,
         command=(f"{_M}.bench.family_spot --n=16777216 "
                  "--out=out/family_spot.json"),
         rehearsal_command=(f"{_M}.bench.family_spot --platform=cpu "
                            "--n=131072 --serve-n=8192 --reps=2 "
                            "--out=out/family_spot.json"),
         artifacts=("out/family_spot.json",),
         done_artifact="out/family_spot.json",
         requires=("smoke",),
         surfaces=("mxu-scan", "xla-cumsum", "seg/segsum",
                   "argk/argmin")),
    Task("serving_recovery", "crash-recovery instrument", value=100.0,
         budget_s=420,
         command=(f"{_M}.serve.loadgen --recovery "
                  "--recovery-requests=48 --crash-after=16 --seed=0 "
                  "--out=out/serving_recovery.json"),
         rehearsal_command=(f"{_M}.serve.loadgen --platform=cpu "
                            "--recovery --recovery-requests=24 "
                            "--crash-after=8 --n=8192 "
                            "--out=out/serving_recovery.json"),
         artifacts=("out/serving_recovery.json",),
         done_artifact="out/serving_recovery.json"),
    Task("flagship", "flagship experiment", value=300.0, budget_s=10800,
         command=f"{_M}.bench.experiment out/experiment",
         artifacts=("out/experiment",),
         hazard=True,       # its tail is the 4 GiB cells
         chip_only=True, requires=("smoke", "calibrate_ladder"),
         surfaces=("k6", "k7", "dd", "torch")),
)


def registry(platform: Optional[str] = None,
             only: Optional[Sequence[str]] = None) -> List[Task]:
    """The active task list. `platform='cpu'` selects the rehearsal
    profile: chip-only tasks drop out (the executor records them
    skipped) and tasks with a rehearsal_command swap it in. `only`
    filters by slug — the focused-rehearsal seam."""
    out: List[Task] = []
    for t in SESSION_TASKS:
        if only is not None and t.name not in only:
            continue
        if platform == "cpu":
            if t.chip_only:
                continue
            if t.rehearsal_command:
                t = dataclasses.replace(t, command=t.rehearsal_command)
        out.append(t)
    return out


def rehearsal_excluded(platform: Optional[str] = None,
                       only: Optional[Sequence[str]] = None) -> List[Task]:
    """Chip-only tasks a cpu-rehearsal plan must record as SKIPPED
    (sched.skip reason='chip-only') instead of silently dropping —
    the no-silent-caps rule of the plan-vs-actual record."""
    if platform != "cpu":
        return []
    return [t for t in SESSION_TASKS if t.chip_only
            and (only is None or t.name in only)]


def load_tasks_file(path: str) -> List[Task]:
    """An explicit JSON registry (`--tasks=FILE`): a list of objects
    with the Task field names (`name` required). Tests and
    chip_smoke.py drive small registries through the real planner and
    executor this way."""
    data = json.loads(open(path).read())
    if not isinstance(data, list):
        raise ValueError(f"{path}: tasks file must be a JSON list")
    out = []
    for i, spec in enumerate(data):
        if not isinstance(spec, dict) or "name" not in spec:
            raise ValueError(f"{path}[{i}]: each task needs a 'name'")
        out.append(Task(
            name=spec["name"], title=spec.get("title", spec["name"]),
            value=float(spec.get("value", 1.0)),
            budget_s=float(spec.get("budget_s", 60.0)),
            command=spec.get("command", "true"),
            artifacts=tuple(spec.get("artifacts", ())),
            done_artifact=spec.get("done_artifact"),
            hazard=bool(spec.get("hazard", False)),
            chip_only=bool(spec.get("chip_only", False)),
            requires=tuple(spec.get("requires", ())),
            surfaces=tuple(spec.get("surfaces", ()))))
    return out


def registry_hash(tasks: Sequence[Task]) -> str:
    """Stable digest of the active registry — part of the plan state's
    meta contract (sched/state.py): a state persisted against a
    different task set must re-plan fresh, never resume."""
    blob = json.dumps([dataclasses.asdict(t) for t in tasks],
                      sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def by_name(tasks: Sequence[Task]) -> Dict[str, Task]:
    """Slug -> Task index (duplicate slugs are a registry bug: loud)."""
    out: Dict[str, Task] = {}
    for t in tasks:
        if t.name in out:
            raise ValueError(f"duplicate task slug {t.name!r}")
        out[t.name] = t
    return out
