"""The port stands alone: tpu_reductions_torch/ and chip_smoke.py import
neither jax nor any tpu_reductions module, and without a card and without
an explicit CPU request the entry points (the benchmark, collective,
round, exec, serve, loadgen, ledger, router and relay CLIs, a process of
a multi-process collective run and bench/multicard's worker), the serving
executor, its shard route and the fleet's process replicas, and the kernel
wrappers raise rather than run on the CPU. Every kernel wrapper (k6-k10 and the pair kernel dd)
takes its plain version only for a CPU tensor."""

import ast
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_reductions_torch import device as device_mod
from tpu_reductions_torch.bench import driver
from tpu_reductions_torch.config import ReduceConfig
from tpu_reductions_torch.ops import dd_reduce as dd
from tpu_reductions_torch.ops import kernel_reduce as kr
from tpu_reductions_torch.ops.stream import StreamReducer
from tpu_reductions_torch.ops.registry import get_op
from tpu_reductions_torch.utils.logging import BenchLogger

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "tpu_reductions_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return root in ("jax", "jaxlib") or root == "tpu_reductions"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("__import__", "import_module") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names = [node.args[0].value]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, runpy, sys\n"
        "import tpu_reductions_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    if m.name != 'tpu_reductions_torch.__main__':\n"
        "        importlib.import_module(m.name)\n"
        "runpy.run_path('chip_smoke.py', run_name='not_main')\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'tpu_reductions')]\n"
        "print(len([k for k in sys.modules "
        "if k.startswith('tpu_reductions_torch.')]))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 18   # every module was imported


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a CUDA device")


def test_entry_points_raise_without_card(no_card):
    with pytest.raises(RuntimeError, match="--platform=cpu"):
        device_mod.resolve("gpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kr.kernel_reduce(torch.arange(100, dtype=torch.int32), "SUM")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.run_benchmark(ReduceConfig(n=4096, log_file=None),
                             logger=BenchLogger(console=io.StringIO()))
    stage_fn, _ = kr.make_staged_reduce("SUM", 100, "int32",
                                        device=torch.device("cuda"))
    with pytest.raises((RuntimeError, AssertionError)):
        stage_fn(torch.arange(100, dtype=torch.int32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dd.dd_reduce_f64(np.ones(100), "SUM")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamReducer("SUM", "int32", 100)


def test_cli_raises_without_card(no_card):
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_reductions_torch", "--method=SUM",
         "--n=4096", "--logfile="], cwd=REPO, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "PASSED" not in proc.stdout


@pytest.mark.parametrize("argv", [
    ["tpu_reductions_torch.bench.collective_driver", "--method=SUM",
     "--n=4096", "--devices=4"],
    ["tpu_reductions_torch.bench.round", "--n=4096"],
], ids=["collective", "round"])
def test_collective_and_round_clis_raise_without_card(no_card, argv):
    """Without --platform=cpu they need the card: no CPU fallback."""
    proc = subprocess.run(
        [sys.executable, "-m", *argv], cwd=REPO, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "PASSED" not in proc.stdout


@pytest.mark.parametrize("argv", [
    ["tpu_reductions_torch.bench.collective_driver", "--method=SUM",
     "--n=4096", "--devices=2", "--num-processes=2", "--process-id=0",
     "--coordinator=127.0.0.1:1"],
    ["tpu_reductions_torch.bench.multicard", "--rows={rows}",
     "--out={out}", "--num-processes=2", "--process-id=0",
     "--coordinator=127.0.0.1:1"],
], ids=["collective_processes", "multicard_worker"])
def test_multi_process_entry_points_raise_without_card(no_card, argv,
                                                       tmp_path):
    """A card process of a multi-process run, without a card: exit 1 with
    the no-device reason; never gloo on the CPU, and no row."""
    rows = tmp_path / "rows.json"
    rows.write_text('[["--method=SUM", "--n=4096", "--devices=2"]]')
    argv = [a.format(rows=rows, out=tmp_path) for a in argv]
    proc = subprocess.run(
        [sys.executable, "-m", *argv], cwd=REPO, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 1
    assert "no CUDA device" in proc.stderr
    assert "PASSED" not in proc.stdout and "DATATYPE" not in proc.stdout
    assert not (tmp_path / "process0.jsonl").exists() \
        or (tmp_path / "process0.jsonl").read_text() == ""


# the subpackages of the execution core and the serving path
SUBPACKAGES = ("obs", "faults", "exec", "sched", "serve")


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_new_subpackages_are_checked(sub):
    """Each subpackage's modules are among the files the import check
    walks, and importing them loads neither jax nor tpu_reductions."""
    files = [p for p in PORT_FILES
             if p.parent == REPO / "tpu_reductions_torch" / sub]
    assert REPO / "tpu_reductions_torch" / sub / "__init__.py" in files
    assert len(files) >= 2
    code = (
        "import importlib, pkgutil, sys\n"
        f"import tpu_reductions_torch.{sub} as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'tpu_reductions')]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("argv", [
    ["tpu_reductions_torch.exec", "--explain"],
    ["tpu_reductions_torch.serve", "--max-seconds=1"],
    ["tpu_reductions_torch.serve.loadgen", "--clients=1", "--requests=1"],
    ["tpu_reductions_torch.obs.ledger", "note.x"],
    ["tpu_reductions_torch.serve.router", "--replicas=1",
     "--max-seconds=1"],
    ["tpu_reductions_torch.faults.relay", '--schedule=[{"behavior": '
     '"accept"}]', "--max-seconds=1"],
    ["tpu_reductions_torch.serve.loadgen", "--scale",
     "--scale-clients=1"],
], ids=["exec", "serve", "loadgen", "obs", "router", "relay", "fleet"])
def test_exec_serve_and_obs_entry_points_raise_without_card(no_card, argv):
    """Without --platform=cpu they need the card: no CPU fallback."""
    proc = subprocess.run(
        [sys.executable, "-m", *argv], cwd=REPO, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "serving on" not in proc.stdout and "decisions" not in proc.stdout
    assert "routing" not in proc.stdout and "listening" not in proc.stdout


# the replica fleet's modules
FLEET_MODULES = ("serve.router", "serve.journal", "serve.autoscale",
                 "serve.transport", "faults.relay")


@pytest.mark.parametrize("mod", FLEET_MODULES)
def test_fleet_modules_are_checked_and_import_alone(mod):
    """Each of the fleet's modules is among the files the import check
    walks, and importing it alone loads neither jax nor tpu_reductions."""
    path = REPO / "tpu_reductions_torch" / (mod.replace(".", "/") + ".py")
    assert path in PORT_FILES
    code = (f"import tpu_reductions_torch.{mod}, sys\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'tpu_reductions')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_a_process_replica_fails_its_spawn_without_a_card(no_card):
    """A child that cannot reach the card exits: the spawn fails with its
    reason instead of the child coming up on the CPU."""
    from tpu_reductions_torch.serve.router import ProcessReplica
    rep = ProcessReplica("r0")                    # platform gpu
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rep.start()
    assert not rep.alive()


def test_the_sharded_route_has_no_cpu_fallback(no_card):
    from tpu_reductions_torch.serve.executor import BatchExecutor
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchExecutor(ranks=8).run_sharded("SUM", "int32", 1 << 12, 0)


def test_the_serving_executor_has_no_cpu_fallback(no_card):
    from tpu_reductions_torch.serve.engine import ServeEngine
    from tpu_reductions_torch.serve.executor import BatchExecutor
    from tpu_reductions_torch.serve.request import ReduceRequest
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchExecutor().run_batch("SUM", "int32", 8, [0])
    eng = ServeEngine().start()
    r = eng.submit(ReduceRequest(method="SUM", dtype="int", n=8)).result(30)
    eng.stop()
    assert r.status == "error" and "no CUDA device" in r.error


def test_chip_smoke_fails_without_card(no_card):
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


WRAPPERS = {  # name: (wrapper, call(x2d, op))
    "k6": (kr.single_pass_call, lambda x2d, op: kr.single_pass_call(x2d, op)),
    "k7": (kr.two_pass_call, lambda x2d, op: kr.two_pass_call(x2d, op, 8, 4,
                                                             2)),
    "k8": (kr.elementwise_call,
           lambda x2d, op: kr.elementwise_call(x2d, op, 8)),
    "k9": (kr.mxu_call, lambda x2d, op: kr.mxu_call(x2d, op)),
    "k10": (kr.stream_call, lambda x2d, op: kr.stream_call(x2d, op, 8, 2)),
    "dd": (dd.dd_call, lambda x2d, op: dd.dd_call(
        x2d, torch.zeros_like(x2d), op.name, 8)[0]),
}


@pytest.mark.parametrize("call", ["k6", "k7", "k8", "k9", "k10", "dd"])
def test_wrappers_take_plain_version_only_on_cpu(call):
    """A tensor on any device but the CPU goes to the kernel; one the
    kernel cannot take raises instead of falling back."""
    op = get_op("SUM")
    dtype = torch.float32 if call in ("k9", "dd") else torch.int32
    meta = torch.empty((64, 128), dtype=dtype, device="meta")
    cpu = torch.ones((64, 128), dtype=dtype)
    _, run = WRAPPERS[call]
    with pytest.raises(ValueError, match="CUDA tensors"):
        run(meta, op)
    before = [w.launches for w, _ in WRAPPERS.values()]
    got = run(cpu, op)
    assert int(got.sum()) == 64 * 128
    # the plain version is no launch
    assert [w.launches for w, _ in WRAPPERS.values()] == before


# the watchdog, preflight, the flight recorder's analysis and the
# window scheduler
RESILIENCE_MODULES = ("utils.relay_env", "utils.watchdog", "utils.preflight",
                      "utils.calibrate", "utils.compile_cache", "obs.spans",
                      "obs.trace_export", "obs.critical_path",
                      "obs.timeline", "obs.compile", "sched.tasks",
                      "sched.state", "sched.priors", "sched.planner",
                      "sched.executor", "sched.__main__")


@pytest.mark.parametrize("mod", RESILIENCE_MODULES)
def test_resilience_modules_are_checked_and_import_alone(mod):
    """Each module is among the files the import check walks; importing
    it alone loads neither jax nor tpu_reductions, and the scheduler's
    and the analysis's modules load no torch either (they run beside a
    card that may be hung)."""
    path = REPO / "tpu_reductions_torch" / (mod.replace(".", "/") + ".py")
    assert path in PORT_FILES
    light = mod.startswith(("sched.", "obs.")) or mod in (
        "utils.relay_env", "utils.compile_cache", "utils.watchdog")
    code = (f"import tpu_reductions_torch.{mod}, sys\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'tpu_reductions')"
            + (" or k == 'torch'" if light else "") + "]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("argv", [
    ["tpu_reductions_torch.utils.calibrate", "--n=4096"],
    ["tpu_reductions_torch.bench.warm", "--only=k6"],
    ["tpu_reductions_torch.bench.spot", "--n=4096"],
], ids=["calibrate", "warm", "spot"])
def test_resilience_clis_raise_without_card(no_card, argv):
    """Without --platform=cpu they need the card: no CPU fallback."""
    proc = subprocess.run(
        [sys.executable, "-m", *argv], cwd=REPO, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr


def test_preflight_without_a_card_is_not_live(no_card, tmp_path):
    """The preflight reports a card it cannot reach, with exit 4, and
    never falls back to the CPU."""
    env = {**os.environ,
           "TPU_REDUCTIONS_HEALTH_FILE": str(tmp_path / "h.json")}
    env.pop("TPU_REDUCTIONS_PREFLIGHT_PLATFORM", None)
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_reductions_torch.utils.preflight",
         "--timeout=60"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 4
    assert "preflight: WEDGED" in proc.stdout
