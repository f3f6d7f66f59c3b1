"""The port's collective CLI against the JAX package's, on the CPU.

- The parser walked flag by flag: both `build_collective_parser`s offer
  the same flags with the same destinations, defaults and choices, except
  those in DIFFERENT; `parse_collective` refuses the same values with the
  same exit code and reason.
- The CLI at small n: the same header, `DATATYPE OP NODES` rows, QA
  markers (each under its package's name) and exit codes as the JAX CLI
  for the same argv (`--rooted`, `--timing`, the f64 pair route as
  `--f64=dd` against JAX's TPU_REDUCTIONS_FORCE_DD=1, refusals). The port
  adds one `note:` line before its header, saying where its ranks live.
- `--quantized` parses as in JAX; an unsupported (op, dtype, bits) is
  refused with the JAX words, and every supported one at k = 8, and the
  fallback geometry, gives the JAX CLI's verdict, algorithm column and
  exit code.
- Resume from an interrupted `--out`.
- The card's refusals at bring-up, each exit 1 with its reason and the
  FAILED marker: no card, more processes than the host's cards, and two
  processes on one card (cards mocked in the CLI's subprocesses).
- Processes over gloo: `__graft_entry__.dryrun_multihost(2)` as a
  two-process run of the port's CLI, the two-process interleaved
  reduce-scatter that tests/test_mesh_distributed.py runs for JAX, and
  two-process quantized runs (int8/uint8/int16 carriers and their scales
  crossing gloo byte for byte, the coarse keys widened for gloo's
  all_reduce). Each
  run takes its port from the OS, every subprocess has a timeout, and a
  run that fails or hangs has its whole group killed.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import pytest

from tpu_reductions import config as jax_config
from tpu_reductions.bench import collective_driver as jax_driver
from tpu_reductions_torch import config as port_config
from tpu_reductions_torch.bench import collective_driver as port_driver
from tpu_reductions_torch.bench.multicard import free_port, run_group
from tpu_reductions_torch.utils import timing as port_timing

REPO = Path(__file__).resolve().parents[1]

# flag: what differs, on purpose
DIFFERENT = {
    "--platform": "gpu|cpu (default gpu) against the JAX cpu|tpu",
    "--f64": "the port only: float64's native or pair route",
}
# flags that parse alike but that the port's driver refuses: none, now
# that the quantized wire runs
REFUSED_BY_THE_PORT = {}


def _flags(parser) -> dict:
    return {opt: action for action in parser._actions
            for opt in action.option_strings
            if opt.startswith("--") and opt != "--help"}


JAX_FLAGS = _flags(jax_config.build_collective_parser())
PORT_FLAGS = _flags(port_config.build_collective_parser())


def _described(action) -> tuple:
    return (action.dest, action.default, action.type, action.choices,
            action.nargs, action.const, type(action).__name__)


def test_the_walk_covers_every_flag():
    both = set(JAX_FLAGS) | set(PORT_FLAGS)
    assert set(DIFFERENT) <= both
    assert set(REFUSED_BY_THE_PORT) <= set(JAX_FLAGS) & set(PORT_FLAGS)
    for flag in both - set(DIFFERENT):
        assert flag in JAX_FLAGS and flag in PORT_FLAGS, flag


@pytest.mark.parametrize("flag", sorted(set(JAX_FLAGS) | set(PORT_FLAGS)))
def test_flag_matches_the_reference(flag):
    if flag in DIFFERENT:
        port, ref = PORT_FLAGS.get(flag), JAX_FLAGS.get(flag)
        if port is not None and ref is not None:
            assert port.dest == ref.dest
            assert _described(port) != _described(ref)
        return
    assert _described(PORT_FLAGS[flag]) == _described(JAX_FLAGS[flag])


def _refusal(parse, argv) -> tuple:
    """(exit code, message): argparse's, a SystemExit's text, or a
    ValueError/KeyError as the CLI's exit 1."""
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            parse(argv)
    except SystemExit as exc:
        if isinstance(exc.code, str):
            return 1, exc.code
        return exc.code, err.getvalue()
    except (ValueError, KeyError) as exc:
        return 1, str(exc)
    return 0, ""


REFUSALS = [
    ([], 2, "--method={SUM|MIN|MAX} is required"),
    (["--method=AVG"], 1, "method must be one of"),
    (["--type=quad"], 1, "quad"),
    (["--timing=wall"], 2, "invalid choice: 'wall'"),
    (["--mode=xx"], 2, "invalid choice: 'xx'"),
    (["--rooted=leaf"], 2, "invalid choice: 'leaf'"),
    (["--n=many"], 2, "invalid int value: 'many'"),
    (["--bogus"], 2, "unrecognized arguments: --bogus"),
    (["--hel"], 2, "unrecognized arguments: --hel"),
    (["--chainspan=0"], 1, "chain_span must be positive"),
    (["--quantized", "--type=int"], 1, "--quantized does not support SUM"),
    (["--quantized", "--quant-bits=5", "--type=float"], 1,
     "at 5 bits"),
]

# --devices that the processes do not divide: the JAX CLI refuses it (an
# equal local share a process), the port places the ranks in contiguous
# blocks (parallel/mesh.placement) and gives this process its block
UNEVEN = [
    (["--platform=cpu", "--devices=3", "--num-processes=2",
      "--coordinator=127.0.0.1:1", "--process-id=0"], 1,
     "--devices=3 must divide evenly among --num-processes=2", 1),
    (["--platform=cpu", "--devices=3", "--mode=co", "--num-processes=4",
      "--coordinator=127.0.0.1:1", "--process-id=0"], 1,
     "(mode=co provisions 2x that in virtual devices)", 1),
]


@pytest.mark.parametrize("extra, code, reason", REFUSALS + [
    r[:3] for r in UNEVEN],
    ids=[" ".join(r[0]) or "no-method" for r in REFUSALS + UNEVEN])
def test_refusal_matches_the_reference(extra, code, reason):
    argv = (extra if any(a.startswith("--method") for a in extra)
            or not extra else ["--method=SUM", *extra])
    port = _refusal(port_config.parse_collective, argv)
    ref = _refusal(jax_config.parse_collective, argv)
    assert ref[0] == code and reason in ref[1], ref
    uneven = {tuple(r[0]): r[3] for r in UNEVEN}
    if tuple(extra) in uneven:
        # the port's repair: its block, where the JAX CLI refuses
        assert port == (0, "")
        assert port_config.parse_collective(argv).provisioned_ranks \
            == uneven[tuple(extra)]
        return
    assert port[0] == code, (port, ref)
    assert reason in port[1], (port, ref)


def test_valid_flags_parse_to_the_reference_values():
    argv = ["--method=min", "--type=double", "--n=12345", "--seed=3",
            "--retries=2", "--warmup=3", "--devices=4", "--mapping=reversed",
            "--mode=co", "--rooted", "--timing=chained", "--chainspan=7",
            "--coordinator=h:1", "--num-processes=2", "--process-id=1",
            "--out=o.json", "--qatest", "--no-verify"]
    port = port_config.parse_collective(argv)
    ref = jax_config.parse_collective(argv)
    for field in ("method", "dtype", "n", "seed", "retries", "warmup",
                  "num_devices", "mapping", "mode", "rooted", "timing",
                  "chain_span", "coordinator", "num_processes",
                  "process_id", "out", "qatest", "verify", "quantized",
                  "quant_bits", "mesh_shape"):
        assert getattr(port, field) == getattr(ref, field), field
    assert (port.platform, port.f64) == ("gpu", "native")
    assert port.provisioned_ranks == 4      # 4 ranks, co: 2x, 2 processes
    assert port_config.parse_collective(
        ["--method=SUM", "--rooted=root"]).rooted == "root"


# ---------------------------------------------------------------------------
# the CLI against the JAX CLI
# ---------------------------------------------------------------------------

@pytest.fixture
def stable_port_chain(monkeypatch):
    """As tests/conftest.py's stable_chained_timing for the JAX chain: the
    real chained machinery, with a nominal slope only when host noise
    swamped it (the WAIVE path keeps its own test)."""
    real = port_timing.time_chained

    def stabilized(*args, **kwargs):
        sw = real(*args, **kwargs)
        if any(s <= 0 for s in sw.samples):
            return types.SimpleNamespace(samples=[1e-4] * len(sw.samples))
        return sw

    monkeypatch.setattr(port_timing, "time_chained", stabilized)


@pytest.fixture
def stable_jax_chain(monkeypatch):
    """The JAX chain under stable_port_chain's rule: a nominal slope for
    every sample when any sample is non-positive, with the sample count
    kept, so that a loaded host cannot waive one rep on one side only
    (tests/conftest.py's stable_chained_timing substitutes one sample, and
    only when the median or the average is non-positive). The JAX
    driver's WAIVE path keeps its own test
    (tests/test_driver.py::test_noise_swamped_chained_slope_waives)."""
    from tpu_reductions.utils import timing as jax_timing
    real = jax_timing.time_chained

    def stabilized(*args, **kwargs):
        sw = real(*args, **kwargs)
        if any(s <= 0 for s in sw.samples):
            return types.SimpleNamespace(
                average_s=1e-4, median_s=1e-4,
                samples=[1e-4] * len(sw.samples))
        return sw

    monkeypatch.setattr(jax_timing, "time_chained", stabilized)


def _run(main, argv) -> tuple:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _shape(text: str, name: str) -> list:
    """The output's grammar: markers (under a common name), header, row
    prefixes without the rate, and the notes but the port's placement
    note."""
    lines = []
    for line in text.splitlines():
        if line.startswith("&&&&"):
            lines.append(line.replace(name, "NAME"))
        elif line.startswith("note: the ") and "ranks are rows" in line:
            continue
        elif line.startswith(("note:", "DATATYPE", "error:")):
            lines.append(line)
        elif line.strip():
            lines.append(" ".join(line.split()[:3]))
    return lines


CLI_CASES = [
    ["--method=SUM", "--type=int", "--n=4096", "--devices=4"],
    ["--method=MIN", "--type=float", "--n=4096", "--devices=8", "--rooted"],
    ["--method=MAX", "--type=double", "--n=4096", "--devices=4",
     "--rooted=root"],
    ["--method=SUM", "--type=float", "--n=4000", "--devices=6",
     "--rooted=root"],
    ["--method=MIN", "--type=int", "--n=4200", "--devices=6",
     "--rooted=scatter"],
    ["--method=SUM", "--type=int", "--n=8192", "--devices=4",
     "--timing=chained", "--chainspan=4"],
    ["--method=MAX", "--type=double", "--n=8192", "--devices=8",
     "--timing=chained", "--chainspan=4", "--rooted"],
    ["--method=SUM", "--type=double", "--n=4096", "--devices=8",
     "--f64=dd"],
    ["--method=SUM", "--type=double", "--n=4096", "--devices=3",
     "--f64=dd", "--rooted"],
    ["--method=MIN", "--type=double", "--n=4096", "--devices=4",
     "--f64=dd", "--rooted=root"],
    ["--method=MAX", "--type=double", "--n=8192", "--devices=4",
     "--f64=dd", "--timing=chained", "--chainspan=4"],
    ["--type=int", "--n=4096"],
    ["--method=SUM", "--chainspan=0"],
    ["--method=SUM", "--n=2", "--devices=4"],
]


@pytest.mark.parametrize("argv", CLI_CASES,
                         ids=[" ".join(a) for a in CLI_CASES])
def test_cli_gives_the_jax_rows_markers_and_exit(argv, monkeypatch,
                                                 stable_jax_chain,
                                                 stable_port_chain):
    argv = argv + ["--retries=2"]
    jax_argv = [a for a in argv if a != "--f64=dd"]
    monkeypatch.delenv("TPU_REDUCTIONS_FORCE_DD", raising=False)
    port = _run(port_driver.main, argv + ["--platform=cpu"])
    if "--f64=dd" in argv:
        monkeypatch.setenv("TPU_REDUCTIONS_FORCE_DD", "1")
    ref = _run(jax_driver.main, jax_argv)
    assert port[0] == ref[0], (port, ref)
    got = _shape(port[1], "tpu_reductions_torch.collective")
    want = _shape(ref[1], "tpu_reductions.collective")
    # the RUNNING markers echo their own argv
    assert got[0].split()[:3] == want[0].split()[:3] == [
        "&&&&", "RUNNING", "NAME"]
    assert got[1:] == want[1:], (port[1], ref[1])
    if port[0] == 0:
        assert "ranks are rows of one tensor on cpu" in port[1]


def test_quantized_parses_but_the_driver_refuses_it():
    """--quantized parses alike, and the driver refuses what the
    quantized wire cannot carry (integers) with the JAX words and exit
    code; a supported combination runs to PASSED."""
    argv = ["--method=SUM", "--type=float", "--quantized", "--n=4096",
            "--devices=4", "--retries=1"]
    assert port_config.parse_collective(argv).quantized \
        == jax_config.parse_collective(argv).quantized is True
    rc, out, err = _run(port_driver.main, argv + ["--platform=cpu"])
    assert rc == 0
    assert "&&&& tpu_reductions_torch.collective PASSED" in out
    refused = ["--method=MAX", "--type=int", "--quantized", "--n=4096",
               "--devices=4"]
    port = _run(port_driver.main, refused + ["--platform=cpu"])
    ref = _run(jax_driver.main, refused)
    assert port[0] == ref[0] == 1
    words = "--quantized does not support MAX over int32 at 8 bits"
    assert words in port[2] and words in ref[2]
    assert "&&&& tpu_reductions_torch.collective FAILED" in port[1]


QUANT_CLI_CASES = (
    [["--method=SUM", f"--type={t}", f"--quant-bits={b}"]
     for t in ("float", "bfloat16", "double") for b in (4, 8, 16)]
    + [[f"--method={m}", f"--type={t}", f"--quant-bits={b}"]
       for m in ("MIN", "MAX") for t in ("float", "double") for b in (8, 16)]
    + [["--method=SUM", "--type=float", "--n=16376"],
       ["--method=SUM", "--type=double", "--n=16376", "--quant-bits=16"],
       ["--method=SUM", "--type=bfloat16", "--n=16376", "--quant-bits=4"],
       ["--method=SUM", "--type=float", "--rooted=root"],
       ["--method=MIN", "--type=double", "--rooted", "--quant-bits=16"],
       ["--method=SUM", "--type=float", "--timing=chained",
        "--chainspan=4"],
       ["--method=MAX", "--type=double", "--timing=chained",
        "--chainspan=4", "--quant-bits=8"]])


# The one case whose verdicts differ, and why: the JAX oracle sums a
# bfloat16 payload in bfloat16 (np.sum over its ml_dtypes blocks), and at
# 16 bits that rounding alone (7.0e-9 on this payload) exceeds the ring's
# declared bound (4.2e-9), so the JAX CLI fails a ring whose bits equal
# the port's (tests/test_torch_quant.py). The port's oracle adds bfloat16
# in float32, and the row passes.
JAX_ORACLE_FAILS = ("--method=SUM --type=bfloat16 --quant-bits=16",)


@pytest.fixture
def fixed_collective_slopes(monkeypatch):
    """Both collective drivers' chained slopes fixed at 1 ms, one sample
    (torch_routes.fixed_slope runs each chain once through its real
    machinery): at test sizes host noise would decide between PASSED and
    WAIVED, and how many rows a run prints."""
    from tpu_reductions.utils import timing as jax_timing
    from torch_routes import fixed_slope
    monkeypatch.setattr(jax_timing, "time_chained", fixed_slope)
    monkeypatch.setattr(port_timing, "time_chained", fixed_slope)


@pytest.mark.parametrize("argv", QUANT_CLI_CASES,
                         ids=[" ".join(a) for a in QUANT_CLI_CASES])
def test_quantized_cli_gives_the_jax_verdict_algorithm_and_exit(
        argv, tmp_path, monkeypatch, fixed_collective_slopes):
    """Every supported (op, dtype, bits) at k = 8, and the geometry that
    falls back to the exact psum (n = 8 * 2047): the JAX CLI's notes,
    header, row prefixes, markers and exit code, and the same algorithm
    in every row of the --out artifact (JAX_ORACLE_FAILS: the JAX verdict
    is its oracle's, shown here)."""
    monkeypatch.delenv("TPU_REDUCTIONS_FORCE_DD", raising=False)
    case = " ".join(argv)
    argv = (["--quantized", "--devices=8", "--retries=2"] + argv
            + ([] if any(a.startswith("--n=") for a in argv)
               else ["--n=16384"]))
    port = _run(port_driver.main, argv + ["--platform=cpu",
                                          f"--out={tmp_path / 'p.json'}"])
    ref = _run(jax_driver.main, argv + [f"--out={tmp_path / 'j.json'}"])
    p_rows, j_rows = (json.loads((tmp_path / f).read_text())["rows"]
                      for f in ("p.json", "j.json"))
    assert all(r["status"] == "PASSED" for r in p_rows) and port[0] == 0
    assert [(r["algorithm"], r["rooted"]) for r in p_rows] \
        == [(r["algorithm"], r["rooted"]) for r in j_rows]
    if case in JAX_ORACLE_FAILS:
        import numpy as np
        from tpu_reductions.collectives import (host_collective_oracle,
                                                quant_error_bound)
        cfg = jax_config.parse_collective(argv)
        x = jax_driver._build_payload(cfg, 8)
        oracle_err = np.abs(host_collective_oracle(x, 8, "SUM").astype(
            np.float64) - x.astype(np.float64).reshape(8, -1).sum(0)).max()
        assert oracle_err > quant_error_bound(
            "SUM", "bfloat16", 16, 8, float(np.abs(x).max()))
        assert ref[0] == 1
        return
    assert port[0] == ref[0] == 0, (port, ref)
    got = _shape(port[1], "tpu_reductions_torch.collective")
    want = _shape(ref[1], "tpu_reductions.collective")
    assert got[1:] == want[1:], (port[1], ref[1])
    assert [r["status"] for r in p_rows] == [r["status"] for r in j_rows]


# a collective CLI process that sees `cards` mocked cards (none of its
# collectives runs: every case here is refused at bring-up)
MOCKED_CARDS = """
import sys, types
import torch
cards = int(sys.argv[1])
torch.cuda.is_available = lambda: cards > 0
torch.cuda.device_count = lambda: cards
torch.cuda.set_device = lambda d: None
torch.cuda.get_device_properties = lambda d: types.SimpleNamespace(
    uuid=f"GPU-{getattr(d, 'index', d)}", name="mocked card")
from tpu_reductions_torch.bench import collective_driver
sys.exit(collective_driver.main(sys.argv[2:]))
"""


def _refused_group(cards: int, nproc: int, env: dict) -> list:
    """`nproc` card processes of the collective CLI on `cards` mocked
    cards, joined at a port from the OS: (exit code, stdout, stderr)."""
    port = free_port()
    group = run_group(
        [[sys.executable, "-c", MOCKED_CARDS, str(cards), "--method=SUM",
          "--n=4096", f"--devices={nproc}", f"--num-processes={nproc}",
          f"--process-id={i}", f"--coordinator=127.0.0.1:{port}"]
         for i in range(nproc)], 120, env={**os.environ, **env})
    return [(rc, out, err) for rc, (out, err) in zip(group["rcs"],
                                                    group["outs"])]


def _assert_refused(rc, out, err, reason, reports=True):
    assert rc == 1, (out, err)
    assert reason in err, err
    assert "error: bring-up failed" in err
    if not reports:     # only rank 0 prints the QA markers
        assert out.strip() == "", out
        return
    assert out.rstrip().endswith("&&&& tpu_reductions_torch.collective "
                                 "FAILED"), out
    assert "DATATYPE" not in out


def test_card_refuses_more_than_one_process():
    """More processes on a host than it has cards: each process of a
    multi-process card run drives a card of its own, so 2 processes on
    a host of 1 card exit 1 with that reason before any join; never
    moved to the CPU."""
    rc, out, err = _run_mocked(1, [
        "--num-processes=2", "--process-id=0", "--coordinator=127.0.0.1:1",
        "--devices=2"])
    _assert_refused(rc, out, err, "2 processes on this host but 1 card(s)")


def _run_mocked(cards: int, argv: list) -> tuple:
    r = subprocess.run([sys.executable, "-c", MOCKED_CARDS, str(cards),
                        "--method=SUM", "--n=4096", *argv], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    return r.returncode, r.stdout, r.stderr


def test_card_refuses_a_multi_process_run_without_a_card():
    """No card: --num-processes=2 without --platform=cpu exits 1 with
    the no-device reason, never on the CPU or over gloo."""
    r = subprocess.run(
        [sys.executable, "-m", "tpu_reductions_torch.bench.collective_driver",
         "--method=SUM", "--n=4096", "--devices=2", "--num-processes=2",
         "--process-id=0", "--coordinator=127.0.0.1:1"], cwd=REPO,
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    _assert_refused(r.returncode, r.stdout, r.stderr,
                    "no CUDA device is available")
    assert "gloo" not in r.stderr.lower()


def test_card_refuses_two_processes_on_one_card():
    """Two processes whose LOCAL_RANK names one card: both publish their
    card at the rendezvous, both see the clash, and both exit 1 with the
    duplicate-card reason before NCCL is asked."""
    for i, (rc, out, err) in enumerate(
            _refused_group(4, 2, {"LOCAL_RANK": "0"})):
        _assert_refused(rc, out, err, "both drive card", reports=i == 0)
        assert "processes 0 and 1" in err


def test_a_non_positive_slope_waives_the_rep(monkeypatch):
    monkeypatch.setattr(port_timing, "time_chained",
                        lambda *a, **k: types.SimpleNamespace(
                            samples=[-1e-6, 2e-4]))
    cfg = port_config.CollectiveConfig(method="SUM", n=4096, num_devices=4,
                                       retries=2, timing="chained",
                                       platform="cpu")
    rows = port_driver.run_collective_benchmark(
        cfg, logger=port_driver.BenchLogger(None, None,
                                            console=io.StringIO()))
    assert [r.status.name for r in rows] == ["WAIVED", "PASSED"]
    assert rows[0].time_s == 0.0 and rows[1].algorithm == "all_reduce"


def test_suite_runs_the_reduce_c_grid():
    log = io.StringIO()
    rows = port_driver.run_collective_suite(
        port_config.CollectiveConfig(n=2048, num_devices=4, retries=1,
                                     platform="cpu"),
        logger=port_driver.BenchLogger(None, None, console=log))
    assert [(r.dtype, r.method) for r in rows] == [
        (d, m) for d in ("int32", "float64") for m in ("MAX", "MIN", "SUM")]
    assert all(r.passed for r in rows)
    assert log.getvalue().count("DATATYPE OP NODES GB/sec") == 6


def test_rows_keep_the_jax_keys():
    cfg = port_config.CollectiveConfig(method="MIN", n=4096, num_devices=8,
                                       rooted="scatter", retries=1,
                                       platform="cpu")
    rows = port_driver.run_collective_benchmark(
        cfg, logger=port_driver.BenchLogger(None, None,
                                            console=io.StringIO()))
    ref = jax_driver.CollectiveResult("MIN", "int32", 4096, 8, 0,
                                      "scatter", 0.0, 0.0, 0.0,
                                      rows[0].status, "reduce_scatter")
    assert set(rows[0].to_dict()) == set(ref.to_dict())
    assert rows[0].algorithm == "reduce_scatter"
    assert set(port_driver.collective_meta(cfg)) >= set(
        jax_driver.collective_meta(cfg))


def test_resume_from_an_interrupted_out(tmp_path):
    out = tmp_path / "coll.json"
    argv = ["--method=SUM", "--type=int", "--n=4096", "--devices=4",
            "--retries=3", f"--out={out}", "--platform=cpu"]
    rc, first, _ = _run(port_driver.main, argv)
    assert rc == 0
    data = json.loads(out.read_text())
    assert data["complete"] is True and len(data["rows"]) == 3
    data["complete"] = False                 # as an interrupted run left it
    out.write_text(json.dumps(data))
    rc, again, _ = _run(port_driver.main, argv)
    assert rc == 0
    assert "3 row(s) resumed from prior artifact" in again
    assert [ln for ln in again.splitlines() if ln.startswith("INT SUM")] == \
        [ln for ln in first.splitlines() if ln.startswith("INT SUM")]
    assert json.loads(out.read_text())["rows"] == data["rows"]
    # another contract measures afresh
    rc, other, _ = _run(port_driver.main, argv[:-2] + [
        "--retries=2", f"--out={out}", "--platform=cpu"])
    assert rc == 0 and "resumed" not in other


# ---------------------------------------------------------------------------
# processes over gloo
# ---------------------------------------------------------------------------

# what a process prints when the group's rendezvous itself failed (the
# TCP store's socket, gloo's connect), before any of the CLI ran: under a
# loaded host the free port can be taken between free_port and the bind,
# or the store's client socket can fail its hostname lookup and abort
_RENDEZVOUS_FAULT = re.compile(
    r"Address already in use|EADDRINUSE|DistNetworkError|"
    r"\[c10d\].*(socket|connect|hostname)|Connection (refused|reset)")


def _rendezvous_failed(results: list) -> bool:
    """Whether a process died in the rendezvous: it failed, printed no row
    and its stderr names the store's or gloo's socket."""
    return any(rc != 0 and not out.strip() and _RENDEZVOUS_FAULT.search(err)
               for rc, out, err in results)


def _run_group(nproc: int, argv: list, timeout: float = 180) -> list:
    """`nproc` processes of the port's collective CLI over gloo; their
    (exit code, stdout, stderr). A group whose rendezvous failed (not the
    CLI) is started once more on a fresh port."""
    results = _start_group(nproc, argv, timeout)
    if _rendezvous_failed(results):
        results = _start_group(nproc, argv, timeout)
    return results


def _start_group(nproc: int, argv: list, timeout: float) -> list:
    """One group on a fresh port. Every process is killed if one fails to
    finish in time."""
    port = free_port()
    group = run_group(
        [[sys.executable, "-m", "tpu_reductions_torch.bench.collective_driver",
          *argv, "--platform=cpu", f"--coordinator=127.0.0.1:{port}",
          f"--num-processes={nproc}", f"--process-id={i}"]
         for i in range(nproc)], timeout)
    return [(rc, out, err) for rc, (out, err) in zip(group["rcs"],
                                                    group["outs"])]


def _ours(text: str) -> list:
    return [ln for ln in text.splitlines()
            if ln.strip() and not ln.startswith("[Gloo]")]


def test_two_processes_as_dryrun_multihost():
    """`__graft_entry__.dryrun_multihost(2)` for the port: two processes,
    2 ranks each, verified int32 SUM; rank 0 alone reports."""
    (rc0, out0, err0), (rc1, out1, err1) = _run_group(2, [
        "--method=SUM", "--type=int", "--n=65536", "--retries=2",
        "--devices=4"])
    assert rc0 == 0 and rc1 == 0, (out0, err0, out1, err1)
    assert "&&&& tpu_reductions_torch.collective PASSED" in out0
    assert len([ln for ln in out0.splitlines()
                if ln.startswith("INT SUM 4 ")]) == 2
    assert "this process holds 2 of them" in out0
    assert _ours(out1) == []


def test_two_processes_interleaved_scatter_verifies():
    """An interleaved mapping gives each process every other rank; the
    reduce-scatter check must line each local slice up with its global
    position (local_view_and_selection's selector)."""
    results = _run_group(2, [
        "--method=SUM", "--type=int", "--n=65536", "--retries=2",
        "--devices=4", "--mapping=interleaved", "--rooted"])
    for rc, out, err in results:
        assert rc == 0, (out, err)
    assert "&&&& tpu_reductions_torch.collective PASSED" in results[0][1]


def test_two_processes_pair_ring_and_butterfly_verify():
    """The dd ring and the MIN halving butterfly with hops between the
    processes (gloo send/receive), each verified."""
    for argv in (["--method=SUM", "--type=double", "--f64=dd"],
                 ["--method=MIN", "--type=int", "--rooted=root",
                  "--mapping=reversed"]):
        results = _run_group(2, argv + ["--n=16384", "--retries=1",
                                        "--devices=8"])
        for rc, out, err in results:
            assert rc == 0, (argv, out, err)
        assert "&&&& tpu_reductions_torch.collective PASSED" in results[0][1]


def test_two_processes_quantized_sum_and_keys_verify():
    """The quantized wire between processes: the 4-bit SUM ring's packed
    uint8 carriers and f32 scales, and the 16-bit coarse keys of f64 MAX
    (widened to int32 for gloo's all_reduce), each verified."""
    for argv in (["--method=SUM", "--type=float", "--quant-bits=4"],
                 ["--method=MAX", "--type=double", "--quant-bits=16",
                  "--mapping=interleaved"]):
        results = _run_group(2, argv + ["--quantized", "--n=16384",
                                        "--retries=1", "--devices=8"])
        for rc, out, err in results:
            assert rc == 0, (argv, out, err)
        assert "&&&& tpu_reductions_torch.collective PASSED" in results[0][1]
        assert "this process holds 4 of them" in results[0][1]
