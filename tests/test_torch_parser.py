"""The port's CLI parser walked flag by flag against the JAX package's.

Both `build_single_chip_parser`s must offer the same flags with the same
destinations, defaults and choices, and `parse_single_chip` must refuse
the same values with the same exit code and reason: 2 for a usage error
(argparse's own refusals, a missing or unknown --method or --type), 1 for
a value `ReduceConfig` refuses (the JAX CLI lets that ValueError escape,
which exits 1; the port prints the reason and exits 1). Both parsers run
in this process; a refusal that the JAX parser raises as a ValueError
counts as its interpreter's exit 1.

The deliberate differences are listed in DIFFERENT and nowhere else.
"""

import contextlib
import io
import subprocess
import sys
from pathlib import Path

import pytest

from tpu_reductions import config as jax_config
from tpu_reductions_torch import config as port_config

REPO = Path(__file__).resolve().parents[1]

# flag: what differs, on purpose
DIFFERENT = {
    "--platform": "gpu|cpu (default gpu) against the JAX cpu|tpu",
    "--backend": "auto|cuda|torch against the JAX auto|pallas|xla",
    "--f64": "the port only: float64's native or pair route",
}


def _flags(parser) -> dict:
    """Long option -> its argparse action, --help aside."""
    return {opt: action for action in parser._actions
            for opt in action.option_strings
            if opt.startswith("--") and opt != "--help"}


JAX_FLAGS = _flags(jax_config.build_single_chip_parser())
PORT_FLAGS = _flags(port_config.build_single_chip_parser())


def _described(action) -> tuple:
    return (action.dest, action.default, action.type, action.choices,
            action.nargs, action.const, type(action).__name__)


def test_the_walk_covers_every_flag():
    """Every flag is in both parsers or named in DIFFERENT, and DIFFERENT
    names only flags that exist."""
    both = set(JAX_FLAGS) | set(PORT_FLAGS)
    assert set(DIFFERENT) <= both
    for flag in both - set(DIFFERENT):
        assert flag in JAX_FLAGS and flag in PORT_FLAGS, flag


@pytest.mark.parametrize("flag", sorted(set(JAX_FLAGS) | set(PORT_FLAGS)))
def test_flag_matches_the_reference(flag):
    """Name, destination, default, type, choices and action agree, except
    where DIFFERENT says why not."""
    if flag in DIFFERENT:
        port, ref = PORT_FLAGS.get(flag), JAX_FLAGS.get(flag)
        if port is not None and ref is not None:
            assert port.dest == ref.dest
            assert _described(port) != _described(ref), \
                f"{flag} is listed as different but agrees"
        return
    assert _described(PORT_FLAGS[flag]) == _described(JAX_FLAGS[flag])


def _refusal(parse, argv) -> tuple:
    """(exit code, message) of parsing argv: what argparse printed before
    a SystemExit, or a ValueError's text as the uncaught exit 1."""
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            parse(argv)
    except SystemExit as exc:
        return exc.code, err.getvalue()
    except ValueError as exc:
        return 1, str(exc)
    return 0, ""


# argv after --method=SUM unless it names --method; the exit code both
# give; a reason both print
REFUSALS = [
    (["--chunk-bytes=0"], 1, "chunk_bytes must be positive"),
    (["--chunk-bytes=-4096"], 1, "chunk_bytes must be positive"),
    (["--n=0"], 1, "n must be positive"),
    (["--n=-1"], 1, "n must be positive"),
    (["--streambuffers=0"], 1, "stream_buffers must be positive"),
    (["--threads=0"], 1, "threads/max_blocks must be positive"),
    (["--maxblocks=0"], 1, "threads/max_blocks must be positive"),
    (["--chainreps=0"], 1, "chain_reps must be positive"),
    (["--type=quad"], 2, "unknown --type 'quad'"),
    (["--method=AVG"], 2, "--method must be one of"),
    ([], 2, "--method={SUM|MIN|MAX} is required"),
    (["--timing=wall"], 2, "invalid choice: 'wall'"),
    (["--stat=mode"], 2, "invalid choice: 'mode'"),
    (["--n=many"], 2, "invalid int value: 'many'"),
    (["--kernel=six"], 2, "invalid int value: 'six'"),
    (["--bogus"], 2, "unrecognized arguments: --bogus"),
    (["--shmoo", "--shmoo-min=0"], 2, "must satisfy 0 < min <= max"),
    (["--shmoo", "--shmoo-min=12", "--shmoo-max=11"], 2,
     "must satisfy 0 < min <= max"),
]


@pytest.mark.parametrize("extra, code, reason", REFUSALS,
                         ids=[" ".join(r[0]) or "no-method" for r in REFUSALS])
def test_refusal_matches_the_reference(extra, code, reason):
    argv = (extra if not extra or extra[0].startswith("--method")
            else ["--method=SUM", *extra])
    if extra == []:
        argv = ["--type=int"]
    port = _refusal(port_config.parse_single_chip, argv + ["--platform=cpu"])
    ref = _refusal(jax_config.parse_single_chip, argv + ["--platform=cpu"])
    assert port[0] == ref[0] == code, (port, ref)
    assert reason in port[1] and reason in ref[1], (port, ref)


def test_valid_flags_parse_to_the_reference_values():
    """A full argv of the shared flags gives the same config fields."""
    argv = ["--method=max", "--type=double", "--n=12345", "--seed=3",
            "--threads=64", "--kernel=8", "--maxblocks=16",
            "--streambuffers=2", "--cpufinal", "--cputhresh=4",
            "--warmup=2", "--device=0", "--logfile=", "--masterlog=m.txt",
            "--timing=bulk", "--chainreps=3", "--stat=median", "--stream",
            "--chunk-bytes=65536", "--qatest", "--no-verify", "--check",
            "--trace=tr", "--platform=cpu"]
    fields = ("method", "dtype", "n", "seed", "threads", "kernel",
              "max_blocks", "stream_buffers", "cpu_final", "cpu_thresh",
              "iterations", "iterations_explicit", "warmup", "device",
              "log_file", "master_log", "timing", "chain_reps", "stat",
              "stream", "chunk_bytes", "qatest", "verify", "check",
              "trace_dir")
    for extra in ([], ["--iterations=7", "--shmoo", "--shmoo-min=3",
                       "--shmoo-max=5"]):
        port, port_shmoo = port_config.parse_single_chip(argv + extra)
        ref, shmoo = jax_config.parse_single_chip(argv + extra)
        assert port_shmoo == shmoo == ((3, 5) if extra else None)
        for field in fields:
            assert getattr(port, field) == getattr(ref, field), field


def test_cli_refuses_chunk_bytes_zero_with_exit_1():
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_reductions_torch", "--method=SUM",
         "--n=4096", "--chunk-bytes=0", "--platform=cpu", "--logfile="],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    assert "chunk_bytes must be positive" in proc.stderr
    assert "PASSED" not in proc.stdout
