"""The port's compile observatory: the build directory as the compile
cache (utils/compile_cache.py: fingerprint and verdict over a temporary
build directory of fake libraries), the span and probe events
(obs/compile.py, exec/core.observe_compile), the persisted CompileLedger
(merge and persist, the file bench/warm.py writes) and CompileModel, held
against the JAX package's on the same rows."""

import json
import os
import time
from pathlib import Path

import pytest
import torch  # noqa: F401  (the span's platform reads it)

from tpu_reductions.obs import compile as jax_compile
from tpu_reductions.utils import compile_cache as jax_cache
from tpu_reductions_torch.exec import core as exec_core
from tpu_reductions_torch.obs import compile as obs_compile
from tpu_reductions_torch.obs import ledger
from tpu_reductions_torch.utils import compile_cache

CSRC = Path(compile_cache._CSRC)
SOURCES = sorted(p.stem for p in CSRC.glob("*.cu"))


@pytest.fixture(autouse=True)
def build_dir(tmp_path, monkeypatch):
    """Each test reads its own build directory, with unarmed stores."""
    for name in ("TPU_REDUCTIONS_LEDGER", "TPU_REDUCTIONS_COMPILE_LEDGER",
                 "TPU_REDUCTIONS_NO_COMPILE_CACHE"):
        monkeypatch.delenv(name, raising=False)
    d = tmp_path / "build"
    d.mkdir()
    monkeypatch.setattr(compile_cache, "_active_dir", str(d))
    ledger.disarm()
    obs_compile.disarm()
    exec_core.reset_observed()
    yield d
    ledger.disarm()
    obs_compile.disarm()
    exec_core.reset_observed()


def _lib(d: Path, name: str, age_s: float = 0.0) -> Path:
    """A fake built library, `age_s` older than now."""
    p = d / f"lib{name}.so"
    p.write_bytes(b"\x7fELF")
    t = time.time() - age_s
    os.utime(p, (t, t))
    return p


def _lines(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


def test_sources_are_the_kernels():
    assert SOURCES == ["accumulate", "fault", "mxu", "pair", "reduce"]


def test_fingerprint_holds_the_fresh_libraries(build_dir):
    before = compile_cache.fingerprint()
    assert before == frozenset()
    _lib(build_dir, "reduce")
    _lib(build_dir, "pair")
    (build_dir / "liboracle.so").write_bytes(b"x")     # not a kernel's
    (build_dir / "libreduce.so.77.tmp").write_bytes(b"x")
    after = compile_cache.fingerprint()
    assert {e.split("@")[0] for e in after} == {"libreduce.so",
                                                 "libpair.so"}
    assert compile_cache.verdict(before, after) == "cold"
    assert compile_cache.verdict(after, after) == "warm"
    assert compile_cache.verdict(frozenset(), frozenset()) == "untracked"


def test_a_stale_library_is_no_cache_entry(build_dir):
    """Older than its source, a library is rebuilt by ops/_cuda.build:
    it holds nothing, and its rebuild reads cold."""
    newest = max(p.stat().st_mtime for p in CSRC.iterdir())
    stale = _lib(build_dir, "mxu")
    os.utime(stale, (newest - 60, newest - 60))
    assert compile_cache.fingerprint() == frozenset()
    before = compile_cache.fingerprint()
    _lib(build_dir, "mxu")                       # the rebuild
    assert compile_cache.verdict(before, compile_cache.fingerprint()) \
        == "cold"


def test_a_rebuild_changes_the_stamp(build_dir):
    lib = _lib(build_dir, "accumulate", age_s=10)
    before = compile_cache.fingerprint()
    os.utime(lib, None)
    after = compile_cache.fingerprint()
    assert before != after and compile_cache.verdict(before, after) \
        == "cold"


def test_disabled_verdicts_and_enable(build_dir, monkeypatch, tmp_path):
    _lib(build_dir, "reduce")
    monkeypatch.setenv("TPU_REDUCTIONS_NO_COMPILE_CACHE", "1")
    assert compile_cache.fingerprint() == frozenset()
    assert compile_cache.active_dir() is None
    assert compile_cache.enable(str(tmp_path)) is None
    monkeypatch.delenv("TPU_REDUCTIONS_NO_COMPILE_CACHE")
    assert compile_cache.enable(str(tmp_path / "x")) == str(tmp_path / "x")
    assert compile_cache.active_dir() == str(tmp_path / "x")
    assert compile_cache.enable() == compile_cache.default_dir()
    assert compile_cache.default_dir().endswith(
        os.path.join("tpu_reductions_torch", "_build"))


def test_compile_span_emits_cold_then_warm(build_dir, tmp_path):
    ledger.arm(tmp_path / "l.jsonl")
    with obs_compile.compile_span("nvcc", rows=8):
        _lib(build_dir, "reduce")                 # a build landed
    with obs_compile.compile_span("nvcc", rows=8):
        pass                                      # nothing stale
    evs = _lines(tmp_path / "l.jsonl")
    assert [e["ev"] for e in evs] == ["compile.start", "compile.end"] * 2
    ends = [e for e in evs if e["ev"] == "compile.end"]
    assert ends[0]["verdict"] == "cold" and ends[0]["cache_new"] == 1
    assert ends[1]["verdict"] == "warm" and ends[1]["cache_new"] == 0
    assert all(e["surface"] == "nvcc" and e["rows"] == 8 for e in ends)
    assert ends[0]["platform"] == "cpu"          # torch, no CUDA here
    assert obs_compile.last_observation()["verdict"] == "warm"
    # the same keys, in the same order, as the JAX span's events
    with jax_compile.compile_span("nvcc", rows=8):
        pass
    assert list(jax_compile.last_observation()) \
        == list(obs_compile.last_observation())


def test_compile_span_records_error_and_skips_the_store(tmp_path):
    ledger.arm(tmp_path / "l.jsonl")
    store = obs_compile.arm(tmp_path / "cl.json")
    with pytest.raises(ValueError):
        with obs_compile.compile_span("k7"):
            raise ValueError("boom")
    end = _lines(tmp_path / "l.jsonl")[-1]
    assert end["ev"] == "compile.end" and "ValueError" in end["error"]
    assert store.rows == []


def test_observe_compile_carries_the_verdict(build_dir, tmp_path):
    ledger.arm(tmp_path / "l.jsonl")
    with exec_core.observe_compile("serve-bucket/sum", key="a", n=4) as obs:
        obs["extra"] = 1
    with exec_core.observe_compile("serve-bucket/sum", key="a") as obs:
        assert obs is None                        # deduped
    (end,) = [e for e in _lines(tmp_path / "l.jsonl")
              if e["ev"] == "compile.end"]
    assert end["verdict"] == "untracked" and end["cache_new"] == 0
    assert end["n"] == 4 and end["extra"] == 1


def test_compile_ledger_replaces_per_key_and_merges_prior(tmp_path):
    path = tmp_path / "cl.json"
    store = obs_compile.CompileLedger(str(path))
    assert store.prior_complete is None
    store.record({"surface": "k6", "platform": "gpu", "verdict": "cold",
                  "dur_s": 2.0})
    store.record({"surface": "k6", "platform": "gpu", "verdict": "cold",
                  "dur_s": 1.8})
    store.record({"surface": "k6", "platform": "gpu", "verdict": "warm",
                  "dur_s": 0.1})
    data = json.loads(path.read_text())
    assert data["kind"] == "compile-observatory" and data["version"] == 1
    assert data["complete"] is False and len(data["surfaces"]) == 2
    cold = next(r for r in data["surfaces"] if r["verdict"] == "cold")
    assert cold["dur_s"] == 1.8 and cold["count"] == 2
    store.finalize()
    store2 = obs_compile.CompileLedger(str(path))
    assert store2.prior_complete is True and len(store2.rows) == 2
    store2.record({"surface": "dd", "platform": "gpu", "verdict": "cold",
                   "dur_s": 3.0})
    assert len(json.loads(path.read_text())["surfaces"]) == 3
    # the JAX store reads the port's file, and the reverse
    assert jax_compile.CompileLedger(str(path)).rows == store2.rows
    jax_store = jax_compile.CompileLedger(str(tmp_path / "jax.json"))
    jax_store.record({"surface": "k6", "platform": "cpu",
                      "verdict": "warm", "dur_s": 0.2})
    assert obs_compile.CompileLedger(str(tmp_path / "jax.json")).rows \
        == jax_store.rows


def test_arm_prefers_env_then_explicit(tmp_path, monkeypatch):
    assert obs_compile.arm() is None
    monkeypatch.setenv("TPU_REDUCTIONS_COMPILE_LEDGER",
                       str(tmp_path / "env.json"))
    store = obs_compile.arm()
    assert store is not None and store.path.endswith("env.json")
    assert obs_compile.arm() is store
    assert obs_compile.DEFAULT_LEDGER == os.path.join("out",
                                                      "compile_ledger.json")


ROWS = [{"surface": "k6", "verdict": "cold", "dur_s": 30.0},
        {"surface": "k6", "verdict": "warm", "dur_s": 2.0},
        {"surface": "k7", "verdict": "cold", "dur_s": 20.0},
        {"surface": "k9", "verdict": "warm", "dur_s": 1.0},
        {"surface": "nvcc", "verdict": "cold", "dur_s": 11.3},
        {"surface": "nvcc", "verdict": "warm", "dur_s": 0.001}]
QUERIES = [["k6"], ["k7"], ["k9"], ["k6", "k7"], ["k6", "k9"],
           ["k6", "unknown"], ["unknown"], [], ["nvcc"], ["nvcc", "k6"]]


@pytest.mark.parametrize("filled", [False, True])
@pytest.mark.parametrize("surfaces", QUERIES, ids=lambda q: ",".join(q))
def test_compile_model_matches_the_jax_model(build_dir, tmp_path,
                                             monkeypatch, filled, surfaces):
    """The same rows and the same cache standing (empty, or holding an
    entry) give the same warmth, savings and status in both models."""
    jax_dir = tmp_path / "jc"
    jax_dir.mkdir()
    monkeypatch.setattr(jax_cache, "_active_dir", str(jax_dir))
    if filled:
        _lib(build_dir, "reduce")
        (jax_dir / "e-cache").write_bytes(b"x")
    port = obs_compile.CompileModel(ROWS)
    ref = jax_compile.CompileModel(ROWS)
    assert [port.is_warm(s) for s in surfaces] \
        == [ref.is_warm(s) for s in surfaces]
    assert port.saved_s(surfaces) == pytest.approx(ref.saved_s(surfaces))
    assert port.status(surfaces) == ref.status(surfaces)


def test_compile_model_platform_filter(tmp_path):
    path = tmp_path / "cl.json"
    store = obs_compile.CompileLedger(str(path))
    store.record({"surface": "k6", "platform": "cpu", "verdict": "warm",
                  "dur_s": 0.1})
    store.record({"surface": "k7", "platform": "gpu", "verdict": "warm",
                  "dur_s": 0.2})
    gpu = obs_compile.CompileModel.from_file(str(path), platform="gpu")
    assert gpu.known("k7") and not gpu.known("k6")


def test_compile_markdown_table_matches_the_jax_table(tmp_path):
    data = {"kind": "compile-observatory", "version": 1, "complete": True,
            "surfaces": [dict(r, platform="gpu", lower_s=None,
                              compile_s=r["dur_s"]) for r in ROWS]}
    port = obs_compile.compile_markdown(data).splitlines()
    ref = jax_compile.compile_markdown(data).splitlines()
    assert port[:-1] == ref[:-1]
    assert port[-1].endswith("warm ones load from the build directory") \
        or "build directory" in port[-1]


def test_warm_writes_through_the_compile_ledger(tmp_path):
    """bench/warm.py's manifest is obs/compile.CompileLedger's file, with
    its warm.* events."""
    from tpu_reductions_torch.bench import warm
    out = tmp_path / "cl.json"
    ledger.arm(tmp_path / "l.jsonl")
    assert warm.main(["--platform=cpu", "--n=524288", "--only=k6,dd",
                      f"--out={out}"]) == 0
    data = json.loads(out.read_text())
    assert data["complete"] is True
    assert {(r["surface"], r["verdict"]) for r in data["surfaces"]} \
        == {("k6", "cold"), ("k6", "warm"), ("dd", "cold"), ("dd", "warm")}
    evs = [e["ev"] for e in _lines(tmp_path / "l.jsonl")]
    assert evs.count("warm.surface") == 2
    assert "warm.start" in evs and "warm.end" in evs
    assert jax_compile.load(str(out)) == data
