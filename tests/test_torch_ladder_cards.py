"""The rank ladder across cards, on the CPU: gloo processes stand in for
the cards (P = 2 and 4), every group spawned through bench/multicard.py
with a time limit and none of its processes left.

- placement by blocks: a k-rank mesh on P processes for k = 1-8 and
  P = 1-4 (device.rank_blocks: process p holds block p; k < P the first
  k processes, one rank each; uneven blocks such as k = 6 on 4), its
  members and this process's ranks; build_mesh makes the subgroup of the
  members in every process, members or not, once per member tuple, and
  a process outside a mesh enters none of its collectives;
- the repair of `provisioned_ranks`: --devices that the processes do not
  divide gives each process its block, where it floored (or was refused);
- `shared_checkpoint`: rank 0 persists, every process resumes rank 0's
  prior rows; `run_ladder`: a worker that dies fails the ladder with its
  exit code;
- the collective CLI at --devices=2 and 6 in 4 processes against the JAX
  CLI at --devices 2 and 6 on virtual CPU devices: verdicts, algorithms,
  oracle values, and one process's bits where `bits_required` asks;
- `python -m tpu_reductions_torch.bench.sweep --cards=4` over ranks 2, 4
  and 8 at n = 2^12: the JAX sweep's rows (keys, order, verdicts,
  algorithms) and job files, written once by rank 0; a re-run over a cut
  checkpoint in 2 processes reuses its rows;
- `run_rank_scaling` across 4 processes (the sweep over ranks 2, 4, 8 at
  2^12, the probe, the quantized and reshard curves at k = 2 and 4) with
  a Witness, against its one-card twin (`ladder_agrees`: one process's
  bits where item 7's rule asks, else the registry's tolerance) and the
  JAX sweep's and curves' rows; the rank_scaling CLI with
  `--dryrun --cards=2`.
"""

import contextlib
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpu_reductions import config as jax_config
from tpu_reductions.bench import collective_driver as jax_driver
from tpu_reductions.bench import quant_curve as jax_qc
from tpu_reductions.bench import reshard_curve as jax_rc
from tpu_reductions.bench import sweep as jax_sweep
from tpu_reductions.collectives import \
    host_collective_oracle as jax_oracle
from tpu_reductions_torch.bench import collective_driver as port_driver
from tpu_reductions_torch.bench import multicard
from tpu_reductions_torch.bench import quant_curve as port_qc
from tpu_reductions_torch.bench import rank_scaling
from tpu_reductions_torch.bench import reshard_curve as port_rc
from tpu_reductions_torch.bench import sweep as port_sweep
from tpu_reductions_torch.collectives import \
    host_collective_oracle as port_oracle
from tpu_reductions_torch.collectives.rings import _Hop, ring_perm
from tpu_reductions_torch.config import CollectiveConfig, parse_collective
from tpu_reductions_torch.device import rank_blocks
from tpu_reductions_torch.parallel import mesh as port_mesh
from tpu_reductions_torch.utils.logging import BenchLogger

REPO = Path(__file__).resolve().parents[1]
N = 4096
RANKS = (2, 4, 8)
ROW_KEYS = ("method", "dtype", "n", "ranks", "repeat", "rooted", "status",
            "algorithm")
TIMEOUT_S = 400


def quiet() -> BenchLogger:
    return BenchLogger(None, None, console=io.StringIO())


def _mesh(k: int, world: int, process: int) -> port_mesh.RankMesh:
    devs = port_mesh.placement(k, world, local_ranks=k)
    return port_mesh.RankMesh(
        k=k, axis_names=("ranks",), mesh_shape=(k,), devices=tuple(devs),
        process=process, num_processes=world, device=torch.device("cpu"))


# ---------------------------------------------------------------------------
# placement by blocks, subgroups, processes outside a mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [1, 2, 3, 4])
@pytest.mark.parametrize("k", range(1, 9))
def test_placement_by_blocks(k, world):
    """k ranks on P processes: process p holds the contiguous block p of
    device.rank_blocks(k, P), in rank order; with k < P the first k
    processes hold one rank each and the rest none; the members are the
    processes that hold ranks."""
    blocks = rank_blocks(k, world)
    owners = tuple(p for p, block in enumerate(blocks) for _ in block)
    for p in range(world):
        mesh = _mesh(k, world, p)
        assert mesh.owners == owners
        assert mesh.members == tuple(range(min(k, world)))
        want = tuple(blocks[p]) if p < len(blocks) else ()
        assert mesh.owned == want and mesh.member == bool(want)
        assert mesh.k_local == len(want)
        if mesh.member and world > 1 and k > 1:
            assert mesh.spans_processes
    if k < world:
        assert [len(b) for b in blocks] == [1] * k
    sizes = [len(b) for b in blocks]
    assert sum(sizes) == k and max(sizes) - min(sizes) <= 1


def test_uneven_blocks_six_ranks_on_four():
    assert [_mesh(6, 4, p).owned for p in range(4)] == \
        [(0,), (1, 2), (3,), (4, 5)]


class _FakeGroups:
    """torch.distributed as one process of a `world`-process group sees
    it: new_group, all_reduce and the rank, recorded."""

    def __init__(self, monkeypatch, rank: int, world: int) -> None:
        self.calls = []
        monkeypatch.setattr(port_mesh, "_world", lambda: (rank, world))
        monkeypatch.setattr(port_mesh, "_SUBGROUPS", {})
        monkeypatch.setattr(dist, "get_rank", lambda *a, **k: rank)
        monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: world)

        def new_group(ranks=None, **kw):
            self.calls.append(("new_group", tuple(ranks)))
            return ("subgroup", tuple(ranks))

        def refuse(name):
            def call(*a, **kw):
                self.calls.append((name, kw.get("group")))
                if name != "all_reduce" or kw.get("group") is None:
                    raise AssertionError(f"{name} called")
            return call
        monkeypatch.setattr(dist, "new_group", new_group)
        for name in ("all_reduce", "all_gather", "broadcast", "barrier",
                     "batch_isend_irecv", "all_gather_object"):
            monkeypatch.setattr(dist, name, refuse(name))


@pytest.mark.parametrize("rank", range(4))
def test_build_mesh_makes_the_members_subgroup_in_every_process(
        monkeypatch, rank):
    """Every process makes the subgroup of a mesh that leaves processes
    out (torch's new_group is a collective of the whole group), once per
    member tuple; its members warm it with one all-reduce; a mesh over
    every process runs in the whole group."""
    fake = _FakeGroups(monkeypatch, rank, 4)
    two = port_mesh.build_mesh(num_devices=2, platform="cpu")
    again = port_mesh.build_mesh(num_devices=2, platform="cpu")
    assert two.group == again.group == ("subgroup", (0, 1))
    warm = [("all_reduce", ("subgroup", (0, 1)))] if rank < 2 else []
    assert fake.calls == [("new_group", (0, 1))] + warm
    six = port_mesh.build_mesh(num_devices=6, platform="cpu")
    assert six.group is dist.group.WORLD
    assert six.owned == ((0,), (1, 2), (3,), (4, 5))[rank]
    assert len(fake.calls) == 1 + len(warm)


def test_a_process_outside_the_mesh_enters_none_of_its_collectives(
        monkeypatch):
    """Process 3 of 4 at a 2-rank rung: the collective benchmark returns
    no row, the quantized and reshard curve cells none, and its hop plans
    hold nothing to send or receive; no collective is called (the fakes
    raise), only the subgroup's new_group."""
    fake = _FakeGroups(monkeypatch, 3, 4)
    cfg = CollectiveConfig(method="SUM", dtype="int32", n=N, retries=1,
                           num_devices=2, platform="cpu")
    assert port_driver.run_collective_benchmark(cfg, logger=quiet()) == []
    assert port_qc.measure_cell("SUM", "float32", 8, 2, 8192, 0,
                                platform="cpu") is None
    assert port_rc.measure_cell("row_to_col", "exact", 2, 8192, 64, 0,
                                platform="cpu") is None
    mesh = port_mesh.build_mesh(num_devices=2, platform="cpu")
    assert not mesh.member and _Hop(tuple(ring_perm(2)), mesh).wire == []
    assert fake.calls == [("new_group", (0, 1))]


@pytest.mark.parametrize("devices, want", [(2, [1, 1, 0, 0]),
                                           (6, [1, 2, 1, 2]),
                                           (8, [2, 2, 2, 2])])
def test_provisioned_ranks_are_the_blocks(devices, want):
    """The repair: --devices that 4 processes do not divide parses on the
    card and in the workers of bench/multicard.py (`blocks`), and each
    process provisions its block (the parent floored 2 // 4 to 0, and
    refused 6 at the parse); the CLI on --platform=cpu refuses it as the
    JAX CLI does (tests/test_torch_collective_driver.py UNEVEN)."""
    argv = ["--method=SUM", f"--devices={devices}", "--num-processes=4",
            "--coordinator=127.0.0.1:1"]
    got = [parse_collective(argv + [f"--process-id={i}"]
                            ).provisioned_ranks for i in range(4)]
    assert got == want
    workers = [parse_collective(argv + [f"--process-id={i}",
                                        "--platform=cpu"], blocks=True
                                ).provisioned_ranks for i in range(4)]
    assert workers == want


@pytest.mark.parametrize("rank", [0, 1])
def test_shared_checkpoint_resumes_rank_0s_rows(monkeypatch, tmp_path,
                                                rank):
    """Only rank 0 persists; every process takes rank 0's reading of the
    prior artifact, so that all of them resume the same rows."""
    path = tmp_path / "sweep.json"
    row = {"k": 2, "status": "PASSED"}
    path.write_text(json.dumps({"n": 1, "complete": False,
                                "rows": [row]}))
    monkeypatch.setattr(multicard, "_group_rank", lambda: (rank, 2))
    sent = []

    def broadcast(objs, src=0, **kw):
        sent.append(src)
        if rank != 0:   # what rank 0 read
            objs[0] = {2: row}
    monkeypatch.setattr(dist, "broadcast_object_list", broadcast)
    ck = multicard.shared_checkpoint(path, {"n": 1},
                                     key_fn=lambda r: r.get("k"))
    assert sent == [0]
    assert ck.path == (str(path) if rank == 0 else None)
    assert ck.resume(2) == row
    ck.add(row)
    ck.finalize()
    assert json.loads(path.read_text())["complete"] is (rank == 0)


def test_a_worker_that_dies_fails_the_ladder_with_its_exit_code(
        monkeypatch, tmp_path):
    """run_ladder: worker 1 ends its process with exit 7; the ladder
    raises LadderFailed with code 7, nothing is re-run, and no worker is
    left."""
    monkeypatch.setenv("PYTHONPATH", str(REPO / "tests"))
    with pytest.raises(multicard.LadderFailed) as err:
        multicard.run_ladder("ladder_fault:exit_on_rank",
                             {"code": 7, "rank": 1}, 2, platform="cpu",
                             work_dir=tmp_path, timeout_s=120)
    assert err.value.code == 7
    assert "survivors []" in str(err.value)
    assert not (tmp_path / "ladder_result.json").exists() or \
        json.loads((tmp_path / "ladder_result.json").read_text()) == \
        {"rank": 0}


def test_cards_beyond_the_host_are_refused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="this host has 1 card"):
        multicard.host_cards("gpu", 4)
    assert multicard.host_cards("cpu") == 1
    assert multicard.host_cards("cpu", 4) == 4
    assert not multicard.spawns(1) and multicard.spawns(4)


# ---------------------------------------------------------------------------
# the collective CLI at --devices = 2 and 6 in four processes
# ---------------------------------------------------------------------------

CLI_ROWS = [[f"--method={m}", f"--type={t}", f"--n={N}",
             f"--devices={d}", "--retries=2"]
            for d in (2, 6) for t in ("int", "double")
            for m in ("SUM", "MIN", "MAX")]
# a reduce-scatter needs a rank's length to divide by the ranks: 4104 =
# 6 * 6 * 114 (at 4096 both CLIs FAIL the row, by the same rule)
CLI_ROWS += [["--method=SUM", "--type=int", "--n=4104", "--devices=6",
              "--rooted=scatter", "--retries=2"],
             ["--method=MIN", "--type=int", f"--n={N}", "--devices=2",
              "--rooted=root", "--retries=2"],
             ["--method=SUM", "--type=double", "--f64=dd", f"--n={N}",
              "--devices=6", "--retries=2"],
             ["--method=SUM", "--type=int", f"--n={N}", "--devices=6",
              "--timing=chained", "--chainspan=4", "--retries=2"]]


@pytest.fixture(scope="module")
def cli_rows(tmp_path_factory):
    """CLI_ROWS in 4 gloo processes (bench/multicard.launch), and in one
    process (the twins)."""
    run = multicard.launch(CLI_ROWS, 4, tmp_path_factory.mktemp("cli"),
                           platform="cpu", timeout_s=TIMEOUT_S)
    run["twin"] = list(multicard.twins(CLI_ROWS, "cpu"))
    return run


def _jax_cli(argv, tmp_path, monkeypatch) -> tuple:
    monkeypatch.delenv("TPU_REDUCTIONS_FORCE_DD", raising=False)
    if "--f64=dd" in argv:
        monkeypatch.setenv("TPU_REDUCTIONS_FORCE_DD", "1")
    out = tmp_path / "jax.json"
    with contextlib.redirect_stdout(io.StringIO()):
        rc = jax_driver.main([a for a in argv if a != "--f64=dd"]
                             + [f"--out={out}"])
    return rc, json.loads(out.read_text())["rows"]


def _verified(rows) -> list:
    """A chained rep WAIVED for a non-positive slope verified first."""
    return ["FAILED" if r["status"] == "FAILED" else "verified"
            for r in rows]


@pytest.mark.parametrize("i", range(len(CLI_ROWS)),
                         ids=[" ".join(r[:4]) for r in CLI_ROWS])
def test_the_cli_at_devices_2_and_6_gives_the_jax_verdicts(
        cli_rows, i, tmp_path, monkeypatch):
    argv = CLI_ROWS[i]
    assert cli_rows["rcs"] == [0] * 4 and cli_rows["survivors"] == []
    recs = [r[i] for r in cli_rows["records"]]
    cfg = parse_collective(argv + ["--platform=cpu"])
    k = cfg.num_devices
    members = min(k, 4)
    # the first min(k, 4) processes hold the ranks, the rest are idle
    assert [bool(rec.get("idle")) for rec in recs] == \
        [p >= members for p in range(4)]
    held = recs[:members]
    rc, jax_rows = _jax_cli(argv, tmp_path, monkeypatch)
    assert rc == 0
    for rec in held:
        assert _verified(rec["results"]) == _verified(jax_rows) == \
            ["verified"] * 2
        assert [r["algorithm"] for r in rec["results"]] == \
            [r["algorithm"] for r in jax_rows]
        assert {r["cards"] for r in rec["results"]} == {members}
    assert [(r["ranks"], r["rooted"]) for r in held[0]["results"]] == \
        [(r["ranks"], r["rooted"]) for r in jax_rows]
    jcfg = jax_config.parse_collective([a for a in argv if a != "--f64=dd"])
    want = jax_oracle(jax_driver._build_payload(jcfg, k), k, jcfg.method)
    got = port_oracle(port_driver._build_payload(cfg, k), k, cfg.method)
    assert np.array_equal(np.asarray(want), np.asarray(got))
    tw = cli_rows["twin"][i]
    alg = held[0]["results"][0]["algorithm"]
    if multicard.bits_required(cfg.method, cfg.dtype, alg):
        assert multicard.same_bits(tw["views"], recs), argv
    else:
        ok, diff = multicard.within_tolerance(
            tw["views"], cli_rows["kept"][i], cfg.method, cfg.dtype, cfg.n)
        assert ok, (argv, diff)


@pytest.mark.parametrize("devices", [2, 6])
def test_the_collective_cli_itself_in_four_processes(devices):
    """`python -m tpu_reductions_torch.bench.collective_driver` in four
    processes at --devices=2 and 6 on --platform=cpu: every process exits
    1 at the parse with the JAX CLI's words, before it joins, and none is
    left (the JAX CLI provisions an equal share of virtual CPU devices a
    process; the workers of bench/multicard.py, above, place the blocks)."""
    port = multicard.free_port()
    group = multicard.run_group(
        [[sys.executable, "-m",
          "tpu_reductions_torch.bench.collective_driver", "--method=MIN",
          "--type=double", f"--n={N}", f"--devices={devices}",
          "--retries=2", "--platform=cpu", "--num-processes=4",
          f"--coordinator=127.0.0.1:{port}", f"--process-id={i}"]
         for i in range(4)], TIMEOUT_S)
    assert group["rcs"] == [1] * 4, group["outs"]
    assert group["survivors"] == []
    words = (f"--devices={devices} must divide evenly among "
             f"--num-processes=4")
    assert all(words in err for _, err in group["outs"]), group["outs"]
    out0 = group["outs"][0][0]
    assert f"DOUBLE MIN {devices} " not in out0
    assert "&&&& tpu_reductions_torch.collective FAILED" in out0


# ---------------------------------------------------------------------------
# the sweep CLI across four processes, and a cut checkpoint on two
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sweep_cli(tmp_path_factory):
    out = tmp_path_factory.mktemp("sweep4")
    group = multicard.run_group(
        [[sys.executable, "-m", "tpu_reductions_torch.bench.sweep",
          "--cards=4", "--platform=cpu", f"--ranks={','.join(map(str, RANKS))}",
          f"--n={N}", f"--out-dir={out}"]], TIMEOUT_S)
    return out, group


@pytest.fixture(scope="module")
def jax_ladder(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_sweep")
    rows = jax_sweep.sweep_collective(rank_counts=RANKS, n=N, retries=1,
                                      out_dir=str(out), logger=quiet())
    return out, rows


def _job_shape(path: Path) -> list:
    """A job file's grammar: headers and rows without their rate; the
    port's placement notes left out."""
    return [line if line.startswith("DATATYPE")
            else " ".join(line.split()[:3])
            for line in path.read_text().splitlines()
            if not line.startswith("note:")]


def test_the_sweep_cli_across_four_processes_gives_the_jax_rows(
        sweep_cli, jax_ladder):
    out, group = sweep_cli
    assert group["rcs"] == [0], group["outs"]
    assert group["survivors"] == []
    assert "swept 18 rows across ranks=[2, 4, 8]" in group["outs"][0][0]
    data = json.loads((out / "collective_sweep.json").read_text())
    jax_out, ref = jax_ladder
    assert data["complete"] is True
    port = data["rows"]
    assert [tuple(r[k] for k in ROW_KEYS) for r in port] == \
        [tuple(r[k] for k in ROW_KEYS) for r in ref]
    assert {r["status"] for r in port} == {"PASSED"}
    # the ladder's own keys: the rung's cards and busbw a card
    assert set(port[0]) == set(ref[0]) | {"cards", "busbw_per_card_gbps"}
    assert [r["cards"] for r in port] == [min(r["ranks"], 4) for r in port]
    # rank 0 alone wrote each job file: header and rows once each
    for k in RANKS:
        name = f"raw_output/stdout-vn-{k}ranks.txt"
        assert _job_shape(out / name) == _job_shape(jax_out / name)
    assert sorted(p.name for p in (out / "ladder").glob("ladder*.log")) \
        == [f"ladder{i}.log" for i in range(4)]


def test_a_cut_checkpoint_resumes_its_rows_across_two_processes(
        sweep_cli, tmp_path):
    """The four-process sweep's artifact cut after 8 rows (k = 2 and two
    configs of k = 4), left incomplete: a sweep over two processes reuses
    those 8 rows (the same times), measures the other 10 on its two
    processes, and a Witness holds only the measured ones."""
    out, _ = sweep_cli
    data = json.loads((out / "collective_sweep.json").read_text())
    cut = dict(data, complete=False, rows=data["rows"][:8])
    (tmp_path / "collective_sweep.json").write_text(json.dumps(cut))
    witness = multicard.Witness(tmp_path / "evidence")
    rows = port_sweep.sweep_collective(
        rank_counts=RANKS, n=N, retries=1, platform="cpu",
        out_dir=str(tmp_path), logger=quiet(), cards=2, witness=witness)
    assert len(rows) == 18 and {r["status"] for r in rows} == {"PASSED"}
    assert rows[:8] == cut["rows"]
    assert [r["cards"] for r in rows[8:]] == [2] * 10
    done = json.loads((tmp_path / "collective_sweep.json").read_text())
    assert done["complete"] is True and done["rows"] == rows
    recs = [json.loads(line) for i in range(2) for line in
            (tmp_path / "evidence" / f"process{i}.jsonl").read_text()
            .splitlines()]
    assert len(recs) == 2 * 10
    assert {tuple(r["key"]) for r in recs} == {
        (r["ranks"], r["dtype"], r["method"]) for r in rows[8:]}
    job = (tmp_path / "raw_output" / "stdout-vn-2ranks.txt").read_text()
    assert [line.split()[:3] for line in job.splitlines()
            if len(line.split()) == 4 and line.split()[2].isdigit()] == \
        [[{"int32": "INT", "float64": "DOUBLE"}[r["dtype"]], r["method"],
          "2"] for r in rows[:6]]


# ---------------------------------------------------------------------------
# the rank-scaling experiment across four processes, against its twin
# ---------------------------------------------------------------------------

CURVE_N, CURVE_ROWS, CURVE_RANKS = 8192, 64, (2, 4)
SCALING = dict(ranks=list(RANKS), n=N, retries=1, curve_n=CURVE_N,
               rows=CURVE_ROWS, curve_ranks=list(CURVE_RANKS),
               platform="cpu")


@pytest.fixture(scope="module")
def scaling(tmp_path_factory):
    """run_rank_scaling across 4 gloo processes with a Witness, and its
    one-card twin (cards=1) with another."""
    root = tmp_path_factory.mktemp("scaling")
    ladder = rank_scaling.run_rank_scaling(
        root / "cards", cards=4, witness=multicard.Witness(root / "ev4"),
        logger=quiet(), **SCALING)
    twin = rank_scaling.run_rank_scaling(
        root / "twin", cards=1, witness=multicard.Witness(root / "ev1"),
        logger=quiet(), **SCALING)
    return root, ladder, twin


def test_every_ladder_row_has_one_cards_bits_or_its_tolerance(scaling):
    """ladder_agrees over the sweep, the probe and both curves: every row
    recorded by each process of its rung, with one card's bits where the
    rule asks (int32, MIN/MAX, the quantized rings, the reshard programs
    that only move data), else within registry.tolerance (float64 SUM
    through psum, the reshard that adds partials)."""
    root, ladder, twin = scaling
    verdicts = multicard.ladder_agrees(root / "ev4", root / "ev1")
    assert [v for v in verdicts if not v[2]] == []
    by = {(stage, key): words for stage, key, _, words in verdicts}
    assert {stage for stage, _ in by} == {"sweep", "probe", "quant",
                                          "reshard"}
    assert len(by) == 18 + 3 + len(port_qc.curve_cells(CURVE_RANKS)) \
        + len(port_rc.curve_cells(CURVE_RANKS))
    for (stage, key), words in by.items():
        if stage == "sweep":
            tol = key[1] == "float64" and key[2] == "SUM"
        elif stage == "reshard":
            tol = key[0] == "partial_to_row"
        else:
            continue
        assert ("registry.tolerance" in words) is tol, (stage, key, words)
        assert ("same bits" in words) is not tol
    # the rank-2 rung on two processes, rank 8 two ranks a process
    assert by[("sweep", (2, "int32", "MAX"))].endswith("in 2 process(es)")
    assert by[("sweep", (8, "int32", "MAX"))].endswith("in 4 process(es)")


def test_the_ladders_sweep_is_the_jax_sweep(scaling, jax_ladder):
    _, ladder, twin = scaling
    _, ref = jax_ladder
    for rows in (ladder["sweep"], twin["sweep"]):
        assert [tuple(r[k] for k in ROW_KEYS) for r in rows] == \
            [tuple(r[k] for k in ROW_KEYS) for r in ref]
    assert [r["cards"] for r in ladder["sweep"]] == \
        [min(r["ranks"], 4) for r in ladder["sweep"]]
    assert all("cards" not in r for r in twin["sweep"])


def test_the_ladders_shape_names_its_placement(scaling):
    root, ladder, twin = scaling
    shape = json.loads((root / "cards" / "scaling_shape.json").read_text())
    assert shape["cards"] == 4
    assert shape["ranks_a_card"] == {"2": [1, 1], "4": [1, 1, 1, 1],
                                     "8": [2, 2, 2, 2]}
    assert "min(k, 4) processes" in shape["note"]
    assert len(shape["amortization_probe"]) == 3
    assert ladder["probe_dropped"] == twin["probe_dropped"] == []
    assert "cards" not in json.loads(
        (root / "twin" / "scaling_shape.json").read_text())


@pytest.mark.parametrize("k", CURVE_RANKS)
def test_the_ladders_curves_are_the_jax_curves(scaling, k):
    """The quantized and reshard curve cells at k across the processes:
    the JAX cells' status, algorithm, wire accounting and bound, and the
    JAX program and memory accounting; as many cells as the twin's."""
    _, ladder, twin = scaling
    assert len(ladder["quant"]) == len(twin["quant"])
    assert len(ladder["reshard"]) == len(twin["reshard"])
    for got in (r for r in ladder["quant"] if r["ranks"] == k):
        ref = jax_qc.measure_cell(got["method"], got["dtype"], got["bits"],
                                  k, CURVE_N, 0)
        for key in ("status", "algorithm", "baseline_algorithm",
                    "wire_factor", "bound"):
            assert got[key] == ref[key], (got, key)
        assert got["status"] == "PASSED"
    for got in (r for r in ladder["reshard"] if r["ranks"] == k):
        ref = jax_rc.measure_cell(got["pair"], got["wire"], k, CURVE_N,
                                  CURVE_ROWS, 0)
        for key in ("status", "program", "algorithms", "plan_wire_bytes",
                    "mem_factor", "measured_mem_factor"):
            assert got[key] == ref[key], (got, key)
        assert got["status"] == "PASSED"


def test_the_rank_scaling_cli_dryrun_across_two_processes(tmp_path):
    out = tmp_path / "rs"
    group = multicard.run_group(
        [[sys.executable, "-m", "tpu_reductions_torch.bench.rank_scaling",
          str(out), "--dryrun", "--cards=2", "--ranks=2,4", f"--n={N}",
          f"--curve-n={CURVE_N}", f"--rows={CURVE_ROWS}"]], TIMEOUT_S)
    assert group["rcs"] == [0], group["outs"]
    assert group["survivors"] == []
    assert "stage reshard_curve" in group["outs"][0][0]
    shape = json.loads((out / "scaling_shape.json").read_text())
    assert shape["cards"] == 2
    assert shape["ranks_a_card"] == {"2": [1, 1], "4": [2, 2]}
    quant = json.loads((out / "quant_curve.json").read_text())["rows"]
    reshard = json.loads((out / "reshard_curve.json").read_text())["rows"]
    assert len(quant) == len(port_qc.curve_cells((2, 4)))
    assert len(reshard) == len(port_rc.curve_cells((2, 4)))
    assert {r["status"] for r in quant + reshard} == {"PASSED"}
