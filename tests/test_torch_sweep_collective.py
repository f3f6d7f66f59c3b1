"""The port's collective sweeps and the rank-axis CLIs against the JAX
package's, on the CPU.

- `sweep_collective`: the rows (keys, order, verdicts, algorithms) and
  the per-job `stdout-vn-{k}ranks.txt` files of the JAX sweep for the
  same ladder, but for the rates and the port's placement note; an
  interrupted sweep resumes its rows;
- `shmoo_collective`: the JAX sizes, keys and verdicts;
- the CLIs of the sweep, quant_curve and reshard_curve walked flag by
  flag against JAX's parsers (the port adds --platform gpu|cpu, default
  gpu, and gives --out a default under out/), with the JAX refusals'
  words and exit codes; rank_scaling's own refusals;
- `bench.rank_scaling --dryrun` end to end at small sizes, and
  `bench.regen` folding both curves into report.md.
"""

import argparse
import contextlib
import io
import json
from pathlib import Path

import pytest

from tpu_reductions.bench import quant_curve as jax_qc
from tpu_reductions.bench import reshard_curve as jax_rc
from tpu_reductions.bench import sweep as jax_sweep
from tpu_reductions_torch.bench import quant_curve as port_qc
from tpu_reductions_torch.bench import rank_scaling
from tpu_reductions_torch.bench import regen
from tpu_reductions_torch.bench import reshard_curve as port_rc
from tpu_reductions_torch.bench import sweep as port_sweep
from tpu_reductions_torch.utils.logging import BenchLogger

ROW_KEYS = ("method", "dtype", "n", "ranks", "repeat", "rooted", "status",
            "algorithm")


def quiet():
    return BenchLogger(None, None, console=io.StringIO())


def _job_shape(path: Path) -> list:
    """A job file's grammar: headers and each row without its rate; the
    port's placement note left out."""
    lines = []
    for line in path.read_text().splitlines():
        if "ranks are rows of one tensor" in line:
            continue
        lines.append(line if line.startswith("DATATYPE")
                     else " ".join(line.split()[:3]))
    return lines


def test_sweep_collective_gives_the_jax_rows_and_job_files(tmp_path):
    kw = dict(rank_counts=(2, 4), n=4096, retries=2)
    port = port_sweep.sweep_collective(**kw, platform="cpu",
                                       out_dir=str(tmp_path / "port"),
                                       logger=quiet())
    ref = jax_sweep.sweep_collective(**kw, out_dir=str(tmp_path / "jax"),
                                     logger=quiet())
    assert [tuple(r[k] for k in ROW_KEYS) for r in port] == \
        [tuple(r[k] for k in ROW_KEYS) for r in ref]
    assert all(r["status"] == "PASSED" for r in port)
    assert set(port[0]) == set(ref[0])
    for k in (2, 4):
        name = f"raw_output/stdout-vn-{k}ranks.txt"
        assert _job_shape(tmp_path / "port" / name) == \
            _job_shape(tmp_path / "jax" / name)
    for side in ("port", "jax"):
        data = json.loads((tmp_path / side
                           / "collective_sweep.json").read_text())
        assert data["complete"] is True and len(data["rows"]) == 24
    from tpu_reductions_torch.bench.aggregate import average, collect
    avgs = average(collect(tmp_path / "port" / "raw_output"))
    assert sorted(avgs) == sorted(
        (dt, op, k) for dt in ("INT", "DOUBLE") for op in
        ("MAX", "MIN", "SUM") for k in (2, 4))


def test_an_interrupted_sweep_resumes_its_rows(tmp_path):
    out = tmp_path / "sw"
    first = port_sweep.sweep_collective(rank_counts=(2, 4), n=4096,
                                        retries=1, dtypes=("int32",),
                                        platform="cpu", out_dir=str(out),
                                        logger=quiet())
    ck = out / "collective_sweep.json"
    data = json.loads(ck.read_text())
    data["complete"] = False                  # as an interrupted run left it
    ck.write_text(json.dumps(data))
    # a longer ladder reuses the rungs it shares with the cut one
    again = port_sweep.sweep_collective(rank_counts=(2, 4, 8), n=4096,
                                        retries=1, dtypes=("int32",),
                                        platform="cpu", out_dir=str(out),
                                        logger=quiet())
    assert again[:6] == first
    assert [r["ranks"] for r in again[6:]] == [8, 8, 8]
    job = (out / "raw_output" / "stdout-vn-2ranks.txt").read_text()
    assert "resumed from prior artifact" in job
    # a finished sweep measures afresh
    fresh = port_sweep.sweep_collective(rank_counts=(2,), n=4096,
                                        retries=1, dtypes=("int32",),
                                        platform="cpu", out_dir=str(out),
                                        logger=quiet())
    assert [r["time_s"] for r in fresh] != [r["time_s"] for r in first[:3]]


def test_shmoo_collective_matches_jax():
    kw = dict(method="MAX", dtype="int32", num_devices=4, min_pow=10,
              max_pow=13, retries=1)
    port = port_sweep.shmoo_collective(**kw, platform="cpu",
                                       logger=quiet())
    ref = jax_sweep.shmoo_collective(**kw, logger=quiet())
    assert [tuple(r[k] for k in ROW_KEYS) for r in port] == \
        [tuple(r[k] for k in ROW_KEYS) for r in ref]
    assert [r["n"] for r in port] == [1 << p for p in range(10, 14)]
    assert all(r["gbps"] == r["reference_gbps"] and r["status"] == "PASSED"
               for r in port)


# ---------------------------------------------------------------------------
# the CLIs' parsers against JAX's
# ---------------------------------------------------------------------------

class _Parsed(Exception):
    pass


def parser_of(main) -> argparse.ArgumentParser:
    """The parser a CLI's main builds, caught at its parse_args."""
    seen = {}
    real = argparse.ArgumentParser.parse_args

    def catch(self, args=None, namespace=None):
        seen["p"] = self
        raise _Parsed

    argparse.ArgumentParser.parse_args = catch
    try:
        with pytest.raises(_Parsed):
            main(["x"])
    finally:
        argparse.ArgumentParser.parse_args = real
    return seen["p"]


def _flags(parser) -> dict:
    return {opt: action for action in parser._actions
            for opt in action.option_strings
            if opt.startswith("--") and opt != "--help"}


def _described(action) -> tuple:
    return (action.dest, action.default, action.type, action.choices,
            action.nargs, action.const, type(action).__name__,
            action.required)


# flag: what differs, on purpose
DIFFERENT = {"--platform": "gpu|cpu, default gpu, against the JAX cpu|tpu",
             "--out": "a default under out/ (the curves; JAX: none)"}
# the port's own flags: the processes (cards) the sweep's ladder spans,
# where the JAX sweep's mesh takes every device
PORT_ONLY = {"sweep": {"--cards"}}
CLIS = {"sweep": (port_sweep.main, jax_sweep.main),
        "quant_curve": (port_qc.main, jax_qc.main),
        "reshard_curve": (port_rc.main, jax_rc.main)}


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_cli_flags_match_the_reference(cli):
    port, ref = (_flags(parser_of(m)) for m in CLIS[cli])
    own = PORT_ONLY.get(cli, set())
    assert own <= set(port)
    port = {flag: a for flag, a in port.items() if flag not in own}
    assert set(port) == set(ref)
    for flag in port:
        if flag in DIFFERENT:
            assert port[flag].dest == ref[flag].dest
            continue
        assert _described(port[flag]) == _described(ref[flag]), flag
    assert port["--platform"].choices == ("gpu", "cpu")
    assert port["--platform"].default == "gpu"


def _run(main, argv) -> tuple:
    out, err = io.StringIO(), io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            code = main(argv)
        except SystemExit as e:
            code = e.code
    return code, out.getvalue() + err.getvalue()


REFUSALS = [
    ("sweep", ["--out-dir=D", "--methods=AVG"], "--methods must name only"),
    ("sweep", ["--out-dir=D", "--types=quad"], "--types must name only"),
    ("sweep", ["--out-dir=D", "--ranks=2,x"], "--ranks must be comma-sep"),
    ("sweep", ["--out-dir=D", "--ranks=1,2"], "--ranks must all be >= 2"),
    ("sweep", ["--ranks=2"], "the following arguments are required"),
    ("sweep", ["--out-dir=D", "--timing=wall"], "invalid choice: 'wall'"),
    ("quant_curve", ["--ranks=2,x"], "--ranks/--bits must be comma-sep"),
    ("quant_curve", ["--ranks=1"], "--ranks must all be >= 2"),
    ("quant_curve", ["--n=1000", "--ranks=3"], "--n=1000 must divide"),
    ("quant_curve", ["--bogus"], "unrecognized arguments: --bogus"),
    ("reshard_curve", ["--ranks=x"], "--ranks must be comma-separated"),
    ("reshard_curve", ["--ranks=1"], "--ranks must all be >= 2"),
    ("reshard_curve", ["--n=1000", "--ranks=4"], "must divide by --rows"),
    ("reshard_curve", ["--n=4096", "--rows=8", "--ranks=16"],
     "must both divide by every rank count"),
    ("reshard_curve", ["--quant-bits=5"], "invalid choice: '5'"),
]


@pytest.mark.parametrize("cli, argv, words", REFUSALS,
                         ids=[f"{c}:{' '.join(a)}" for c, a, _ in REFUSALS])
def test_cli_refusals_keep_the_jax_words(cli, argv, words):
    port_main, jax_main = CLIS[cli]
    port = _run(port_main, argv)
    ref = _run(jax_main, argv)
    assert port[0] == ref[0] == 2, (port, ref)
    assert words in port[1] and words in ref[1], (port, ref)


RANK_SCALING_REFUSALS = [
    (["O", "--ranks=1,2"], "--ranks must all be >= 2"),
    (["O", "--ranks=a"], "--ranks must be comma-separated ints"),
    (["O", "--max-ranks=1"], "--max-ranks=1 leaves no rung >= 2"),
    ([], "the following arguments are required: out_dir"),
]


@pytest.mark.parametrize("argv, words", RANK_SCALING_REFUSALS,
                         ids=[" ".join(a) or "none"
                              for a, _ in RANK_SCALING_REFUSALS])
def test_rank_scaling_refusals(argv, words):
    code, text = _run(rank_scaling.main, argv)
    assert code == 2 and words in text


def test_the_sweep_cli_runs_on_the_cpu(tmp_path):
    code, text = _run(port_sweep.main, [
        f"--out-dir={tmp_path}", "--ranks=2", "--n=4096", "--types=int",
        "--methods=SUM", "--platform=cpu"])
    assert code == 0
    assert f"swept 1 rows across ranks=[2] -> {tmp_path}" in text


# ---------------------------------------------------------------------------
# the rank-scaling experiment and the report folds
# ---------------------------------------------------------------------------

def test_rank_scaling_dryrun_end_to_end(tmp_path):
    out = tmp_path / "rank_scaling"
    code, text = _run(rank_scaling.main, [
        str(out), "--dryrun", "--max-ranks=4", "--n=16384",
        "--curve-n=8192", "--rows=64"])
    assert code == 0, text
    shape = json.loads((out / "scaling_shape.json").read_text())
    assert shape["ranks"] == [2, 4]
    assert shape["amortization_probe_ranks"] == 4
    assert shape["timing"] == "periter"
    assert [p[0] for p in shape["amortization_probe"]] == \
        list(rank_scaling.PROBE_NS)
    assert set(shape["series"]) == {f"{d} {o}" for d in ("INT", "DOUBLE")
                                    for o in ("MAX", "MIN", "SUM")}
    assert shape["reference_rows"]["INT SUM"][0] == [64, 9.182]
    assert "host CPU" in shape["note"]
    for fig in ("int", "double", "scaling_shape"):
        assert list(out.glob(f"{fig}.*")), fig
    assert (out / "results" / "INT_SUM.txt").exists()
    quant = json.loads((out / "quant_curve.json").read_text())
    reshard = json.loads((out / "reshard_curve.json").read_text())
    assert len(quant["rows"]) == len(port_qc.curve_cells((2, 4)))
    assert len(reshard["rows"]) == len(port_rc.curve_cells((2, 4)))
    assert all(r["status"] == "PASSED"
               for r in quant["rows"] + reshard["rows"])
    # an experiment dir beside it: regen folds both curves into its report
    exp = tmp_path / "h100"
    (exp / "single_chip").mkdir(parents=True)
    logs = []
    assert regen.regenerate(exp, log=logs.append)
    report = (exp / "report.md").read_text()
    assert port_qc.quant_curve_markdown(quant) in report
    assert port_rc.reshard_curve_markdown(reshard) in report
    assert any("quant_curve" in m for m in logs)
    assert any("reshard_curve" in m for m in logs)


def test_rank_scaling_fails_on_a_dropped_probe_rung(monkeypatch, capsys):
    """A probe rung with no PASSED retry makes the CLI exit 1, as a
    failed sweep row or curve cell does."""
    def run(*args, **kwargs):
        return {"sweep": [{"status": "PASSED"}], "quant": [], "reshard": [],
                "probe_dropped": [1 << 22]}
    monkeypatch.setattr(rank_scaling, "run_rank_scaling", run)
    assert rank_scaling.main(["O", "--max-ranks=2"]) == 1
    assert '"probe_n": 4194304' in capsys.readouterr().err
    monkeypatch.setattr(rank_scaling, "run_rank_scaling",
                        lambda *a, **kw: dict(run(), probe_dropped=[]))
    assert rank_scaling.main(["O", "--max-ranks=2"]) == 0


def test_rank_scaling_without_a_card_raises(monkeypatch, tmp_path):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rank_scaling.main([str(tmp_path / "o"), "--max-ranks=2",
                           "--n=4096"])
