"""A `--platform=cpu` rehearsal of the port's task registry
(sched/tasks.py): every rehearsal command runs to exit 0 and leaves its
completion artifact complete under out/, and the tasks a rehearsal
excludes are the JAX package's chip-only ones, recorded skipped by the
scheduler's own run."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from tpu_reductions.sched import tasks as jax_tasks
from tpu_reductions_torch.sched import tasks as tasks_mod

REPO = Path(__file__).resolve().parents[1]


def _env():
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    for name in ("TPU_REDUCTIONS_LEDGER", "TPU_REDUCTIONS_FAULTS",
                 "TPU_REDUCTIONS_RELAY_MARKER", "TPU_REDUCTIONS_TRACE_CTX"):
        env.pop(name, None)
    return env


@pytest.mark.parametrize("task", tasks_mod.registry(platform="cpu"),
                         ids=lambda t: t.name)
def test_rehearsal_command_runs_green(tmp_path, task):
    (tmp_path / "out").mkdir()       # the scheduler's state makes it
    r = subprocess.run(["bash", "-c", task.command], cwd=tmp_path,
                       env=_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    if task.done_artifact:
        data = json.loads((tmp_path / task.done_artifact).read_text())
        assert data["complete"] is True
    assert not [p for p in tmp_path.iterdir() if p.name != "out"
                and p.suffix == ".json"]       # artifacts under out/ only


def test_rehearsal_excludes_what_jax_excludes():
    port = {t.name for t in tasks_mod.rehearsal_excluded(platform="cpu")}
    assert port == {t.name for t in jax_tasks.rehearsal_excluded("cpu")}
    assert port == {t.name for t in tasks_mod.SESSION_TASKS if t.chip_only}
    assert port.isdisjoint(t.name for t in tasks_mod.registry("cpu"))


def test_scheduler_rehearsal_records_the_exclusions(tmp_path):
    """The scheduler's own `--platform=cpu` run over two rehearsal tasks:
    both done, every chip-only task recorded skipped, the state
    complete."""
    r = subprocess.run(
        [sys.executable, "-m", "tpu_reductions_torch.sched",
         "--platform=cpu", "--only=firstrow,double_spot,flagship,hbm26"],
        cwd=tmp_path, env=_env(), capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    st = json.loads((tmp_path / "out" / "sched_state.json").read_text())
    assert st["complete"] is True and st["platform"] == "cpu"
    statuses = {k: v["status"] for k, v in st["tasks"].items()}
    assert statuses == {"firstrow": "done", "double_spot": "done",
                        "flagship": "skipped", "hbm26": "skipped"}
    assert st["tasks"]["flagship"]["reason"] == "chip-only"
