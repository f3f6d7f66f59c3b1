"""The port's kernel race (tpu_reductions_torch/bench/autotune.py) held
against the JAX package's (tpu_reductions/bench/autotune.py), on the CPU:
the same grids, the same verdict for every candidate on the same payload,
the artifact, resume, and the comparator row."""

import io
import json

import pytest

from tpu_reductions.bench import autotune as jax_autotune
from tpu_reductions.config import ReduceConfig as JaxConfig
from tpu_reductions.ops import oracle as jax_oracle
from tpu_reductions.utils import logging as jax_logging
from tpu_reductions_torch.bench import autotune
from tpu_reductions_torch.config import ReduceConfig
from tpu_reductions_torch.ops import oracle
from tpu_reductions_torch.utils import logging as port_logging

N = 16384


def _geometry(cfg):
    return (cfg.kernel, cfg.threads, cfg.max_blocks, cfg.stream_buffers)


@pytest.mark.parametrize("grid", sorted(autotune.GRIDS))
def test_grids_expand_like_the_jax_race(grid):
    base = dict(method="SUM", dtype="int32", n=N, log_file=None)
    port = autotune.candidate_configs(ReduceConfig(**base),
                                      autotune.GRIDS[grid], comparator=True)
    ref = jax_autotune.candidate_configs(JaxConfig(**base),
                                         jax_autotune.GRIDS[grid],
                                         comparator=True)
    assert [_geometry(c) for c in port[1:]] == \
        [_geometry(c) for c in ref[1:]]
    assert [c.backend for c in port] == ["torch"] + ["cuda"] * len(ref[1:])
    assert ref[0].backend == "xla"


@pytest.mark.parametrize("method, dtype, grid", [
    ("SUM", "float32", "default"), ("MAX", "int32", "default"),
    ("SUM", "bfloat16", "mxu")])
def test_candidates_get_the_jax_verdicts(monkeypatch, method, dtype, grid):
    """Each candidate PASSES or WAIVES in the port's race exactly when it
    does in the JAX race (both native libraries off: both use the numpy
    payload)."""
    monkeypatch.setattr(jax_oracle, "_load", lambda: None)
    monkeypatch.setattr(oracle, "_load", lambda: None)
    fields = dict(method=method, dtype=dtype, n=N, iterations=2, warmup=1,
                  timing="fetch", log_file=None)
    port = autotune.autotune(
        ReduceConfig(platform="cpu", **fields), autotune.GRIDS[grid],
        logger=port_logging.BenchLogger(console=io.StringIO()),
        comparator=True)
    ref = jax_autotune.autotune(
        JaxConfig(**fields), jax_autotune.GRIDS[grid],
        logger=jax_logging.BenchLogger(console=io.StringIO()),
        comparator=True)

    def verdicts(pairs, comparator):
        return sorted(((("comparator" if c.backend == comparator
                         else _geometry(c)), r.status.name)
                       for c, r in pairs), key=repr)

    assert verdicts(port, "torch") == verdicts(ref, "xla")
    statuses = {r.status.name for _, r in port}
    assert "FAILED" not in statuses
    if grid == "mxu" or dtype == "int32":
        assert ("WAIVED" in statuses) == (dtype == "int32")


def _race(tmp_path, *extra):
    out = tmp_path / "tune.json"
    rc = autotune.main(["--method=SUM", "--type=float", f"--n={N}",
                        "--iterations=2", "--platform=cpu", "--grid=mxu",
                        "--comparator", f"--out={out}", *extra])
    return rc, out


def test_out_artifact_and_comparator_row(tmp_path, capsys):
    rc, out = _race(tmp_path, "--timing=fetch")
    assert rc == 0
    data = json.loads(out.read_text())
    assert data["complete"] is True
    assert (data["method"], data["dtype"], data["n"], data["grid"]) == \
        ("SUM", "float32", N, "mxu")
    assert len(data["ranked"]) == len(autotune.MXU_GRID) + 1
    assert data["best"]["backend"] == "cuda"
    assert data["best"]["status"] == "PASSED"
    comparator = [r for r in data["ranked"] if r["backend"] == "torch"]
    assert len(comparator) == 1
    assert (comparator[0]["kernel"], comparator[0]["threads"],
            comparator[0]["max_blocks"]) == (None, None, None)
    assert "stream_buffers" not in comparator[0]
    depths = [r["stream_buffers"] for r in data["ranked"]
              if r["kernel"] == 10]
    assert depths == [4]
    assert "best: cuda kernel=" in capsys.readouterr().out


def test_interrupted_race_resumes_without_racing_its_rows(tmp_path,
                                                          monkeypatch):
    """A `complete: false` artifact (a race cut short) keeps its PASSED and
    WAIVED rows: a rerun races only the rest. A FAILED row races again."""
    raced = []
    real = autotune.run_benchmark

    def counting(cfg, **kwargs):
        raced.append(autotune._cfg_key(cfg))
        return real(cfg, **kwargs)

    monkeypatch.setattr(autotune, "run_benchmark", counting)
    base = ReduceConfig(method="SUM", dtype="float32", n=N, log_file=None)
    keys = [autotune._cfg_key(c) for c in autotune.candidate_configs(
        base, autotune.MXU_GRID, comparator=True)]
    meta = {"method": "SUM", "dtype": "float32", "n": N, "grid": "mxu",
            "timing": "chained", "iterations": 2, "chain_reps": 5,
            "stat": "median", "platform": "cpu"}
    prior = [dict(zip(("backend", "kernel", "threads", "max_blocks"), k[:4]),
                  gbps=1234.5, status=status)
             for k, status in zip(keys[:3], ("PASSED", "WAIVED", "FAILED"))]
    out = tmp_path / "tune.json"
    out.write_text(json.dumps({**meta, "complete": False, "best": None,
                               "ranked": prior}))
    rc = autotune.main(["--method=SUM", "--type=float", f"--n={N}",
                        "--iterations=2", "--platform=cpu", "--grid=mxu",
                        "--comparator", f"--out={out}"])
    assert rc in (0, 1)   # chained slopes on a loaded CPU may all WAIVE
    assert raced == keys[2:]
    data = json.loads(out.read_text())
    assert data["complete"] is True and len(data["ranked"]) == len(keys)
    kept = [r for r in data["ranked"] if r["gbps"] == 1234.5]
    assert sorted(r["status"] for r in kept) == ["PASSED", "WAIVED"]
    # a finished artifact is a finished race: rerunning races afresh
    raced.clear()
    autotune.main(["--method=SUM", "--type=float", f"--n={N}",
                   "--iterations=2", "--platform=cpu", "--grid=mxu",
                   "--comparator", f"--out={out}"])
    assert raced == keys


def test_a_raising_candidate_is_a_failed_row(monkeypatch):
    real = autotune.run_benchmark

    def sabotaged(cfg, **kwargs):
        if cfg.kernel == 9:
            raise RuntimeError("injected launch failure")
        return real(cfg, **kwargs)

    monkeypatch.setattr(autotune, "run_benchmark", sabotaged)
    base = ReduceConfig(method="SUM", dtype="float32", n=N, iterations=2,
                        chain_reps=2, timing="chained", platform="cpu",
                        log_file=None)
    pairs = autotune.autotune(
        base, autotune.MXU_GRID,
        logger=port_logging.BenchLogger(console=io.StringIO()))
    by_kernel = {}
    for cfg, res in pairs:
        by_kernel.setdefault(cfg.kernel, set()).add(res.status.name)
    assert by_kernel[9] == {"FAILED"}
    assert len(pairs) == len(autotune.MXU_GRID)
    assert "FAILED" not in by_kernel[6] | by_kernel[7] | by_kernel[10]
