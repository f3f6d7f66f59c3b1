"""The port's analysis modules held against the JAX package's on the same
inputs, on the CPU: the averaged-rows pipeline (bench/aggregate.py), the
mechanical findings (bench/findings.py), the figures' matplotlib-less
fallback text (bench/plot.py), the report's row builders and report.md
(bench/report.py), the roofline with the card's memory model
(bench/roofline.py), the PDF (bench/pdf.py), the stream probes' table
(bench/stream.stream_markdown), and the row grammar and atomic writes
they rest on.

Every comparison is exact (equal bytes, equal strings, equal floats)
except where a test names the lines the port changes on purpose: the
report's title, its generator line, the sentence naming the device and
its kernels, the port's device line, and the float64 note (native f64 on
the card, where the TPU takes the pair route).
"""

import builtins
import datetime
import difflib
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

from tpu_reductions.bench import aggregate as jax_aggregate
from tpu_reductions.bench import findings as jax_findings
from tpu_reductions.bench import plot as jax_plot
from tpu_reductions.bench import report as jax_report
from tpu_reductions.bench import stream as jax_stream
from tpu_reductions.lint import grammar as jax_grammar
from tpu_reductions.utils import jsonio as jax_jsonio
from tpu_reductions_torch.bench import aggregate, findings, pdf, plot
from tpu_reductions_torch.bench import report, roofline
from tpu_reductions_torch.bench import resume, stream
from tpu_reductions_torch.utils import jsonio
from tpu_reductions_torch.utils import logging as port_logging

REPO = Path(__file__).resolve().parents[1]
DEMO_RAW = REPO / "examples" / "cpu_demo" / "raw_output"


def _rng(seed=0):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# grammar, atomic writes, cell files
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["COLLECTIVE_COLUMNS", "COLLECTIVE_HEADER",
                                  "COLLECTIVE_ROW_TEMPLATE",
                                  "THROUGHPUT_TEMPLATE"])
def test_row_grammar_is_the_jax_packages(name):
    assert getattr(port_logging, name) == getattr(jax_grammar, name)


@pytest.mark.parametrize("indent", [None, 1])
def test_atomic_json_dump_bytes_match_jax(tmp_path, indent):
    obj = {"n": 1 << 24, "gbps": 2341.5, "rows": [1, 2.5, None]}
    jsonio.atomic_json_dump(tmp_path / "a.json", obj, indent=indent)
    jax_jsonio.atomic_json_dump(tmp_path / "b.json", obj, indent=indent)
    assert (tmp_path / "a.json").read_bytes() == \
        (tmp_path / "b.json").read_bytes()
    assert not list(tmp_path.glob("*.tmp"))


def test_atomic_text_dump_replaces_whole_file(tmp_path):
    path = tmp_path / "report.md"
    path.write_text("old and longer text\n")
    jsonio.atomic_text_dump(path, "new\n")
    jax_jsonio.atomic_text_dump(tmp_path / "jax.md", "new\n")
    assert path.read_bytes() == (tmp_path / "jax.md").read_bytes()
    assert not list(tmp_path.glob("*.tmp"))


@pytest.mark.parametrize("content", [
    '{"status": "PASSED", "n": 4096, "trunc', "", "[1, 2]", "not json"])
def test_load_cell_reads_damaged_files_as_empty(tmp_path, content):
    """A truncated or foreign cell file loads as {}, so sweep_all measures
    the cell again; an absent one too."""
    from tpu_reductions.bench.resume import load_cell as jax_load_cell
    f = tmp_path / "run-int32-SUM-0.json"
    f.write_text(content)
    assert resume.load_cell(f) == jax_load_cell(f) == {}
    assert resume.load_cell(tmp_path / "absent.json") == {}


def test_store_cell_round_trips_as_one_line(tmp_path):
    row = {"method": "SUM", "dtype": "int32", "n": 4096, "gbps": 1.25,
           "status": "PASSED", "repeat": 0}
    resume.store_cell(tmp_path / "c.json", row)
    assert resume.load_cell(tmp_path / "c.json") == row
    assert (tmp_path / "c.json").read_text() == json.dumps(row) + "\n"


# ---------------------------------------------------------------------------
# aggregate
# ---------------------------------------------------------------------------


def _raw_dirs(tmp_path):
    """The JAX tests' raw inputs: the committed cpu_demo job files, the
    mixed-format pair, the free-form log and the non-finite rates."""
    mixed = tmp_path / "mixed"
    mixed.mkdir()
    (mixed / "a.txt").write_text("INT SUM 64 9.182\nnoise line\n")
    (mixed / "b.json").write_text(
        '{"dtype": "float64", "method": "MIN", "ranks": 8, '
        '"reference_gbps": 1.5}\n')
    messy = tmp_path / "messy"
    messy.mkdir()
    (messy / "session.log").write_text(
        "=== step 3 done\nchip session step 4 failed\n"
        "wrote tune 42 done\nINT SUM 8 90.841\n")
    (messy / "rows.txt").write_text(
        "INT SUM 8 nan\nINT SUM 8 inf\nINT SUM 8 Infinity\n"
        "INT SUM 16 90.841\nDOUBLE MAX 16 3.5\n")
    (messy / "sweep.json").write_text(
        json.dumps({"dtype": "int32", "method": "SUM", "ranks": 8,
                    "gbps": float("nan"), "status": "PASSED"}) + "\n"
        + '{"dtype": "int32", "method": "SUM", "ranks": 8, '
        '"gbps": Infinity, "status": "PASSED"}\n'
        + json.dumps({"dtype": "int32", "method": "SUM", "ranks": 8,
                      "gbps": 91.159, "status": "PASSED"}) + "\n"
        + json.dumps({"dtype": "bfloat16", "method": "MAX", "ranks": 2,
                      "gbps": 4.0, "status": "FAILED"}) + "\n")
    return {"cpu_demo": DEMO_RAW, "mixed": mixed, "messy": messy}


@pytest.mark.parametrize("which", ["cpu_demo", "mixed", "messy"])
def test_aggregate_pipeline_files_are_byte_equal(tmp_path, which):
    """collect -> collected.txt, average, write_results -> results/*.txt:
    the same rows, the same averages and byte-equal files."""
    raw = _raw_dirs(tmp_path)[which]
    port_out, jax_out = tmp_path / "port", tmp_path / "jax"
    rows = aggregate.collect(raw)
    assert rows == jax_aggregate.collect(raw) and rows
    assert aggregate.average(rows) == jax_aggregate.average(rows)
    written = aggregate.pipeline(raw, port_out)
    jax_written = jax_aggregate.pipeline(raw, jax_out)
    assert [p.name for p in written] == [p.name for p in jax_written]
    for rel in ["collected.txt"] + [f"results/{p.name}" for p in written]:
        assert (port_out / rel).read_bytes() == (jax_out / rel).read_bytes()


def test_average_of_seeded_rows_matches_jax():
    rng = _rng(1)
    rows = [port_logging.COLLECTIVE_ROW_TEMPLATE.format(
        dtype=rng.choice(["INT", "DOUBLE"]), op=rng.choice(["SUM", "MAX"]),
        ranks=int(rng.choice([2, 4, 8])), gbps=float(rng.uniform(0, 100)))
        for _ in range(200)]
    assert aggregate.average(rows) == jax_aggregate.average(rows)


# ---------------------------------------------------------------------------
# findings
# ---------------------------------------------------------------------------


def _curve(seed, regimes):
    """A seeded bandwidth-vs-N curve per (dtype, method): rates rising to a
    plateau, with an optional regime tag per row."""
    rng = _rng(seed)
    rows = []
    for dtype in ("int32", "bfloat16", "float64"):
        plateau = float(rng.uniform(500, 3000))
        for p in range(10, 29):
            g = plateau * (1 - np.exp(-(p - 9) / 4)) * rng.uniform(0.9, 1.1)
            r = {"dtype": dtype, "method": "SUM", "n": 1 << p, "gbps": g}
            if regimes:
                r["regime"] = regimes(dtype, p)
            rows.append(r)
    return rows


@pytest.mark.parametrize("n", [0, 1, 2, 3, 1000, 1024, 1 << 24,
                               (1 << 24) + 37, 1 << 30])
def test_pow2_label_matches_jax(n):
    assert findings.pow2_label(n) == jax_findings.pow2_label(n)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("tagged", [False, True])
def test_half_power_points_match_jax(seed, tagged):
    """Equal lines; with tags, the asymptote is the HBM-bound median in
    both (the port tags the on-chip regime l2_resident, the JAX package
    vmem_resident; half_power_points reads only hbm_bound)."""
    def tag(onchip):
        return ((lambda d, p: onchip if p < 23 else "hbm_bound")
                if tagged else None)
    port = findings.half_power_points(_curve(seed, tag("l2_resident")))
    ref = jax_findings.half_power_points(_curve(seed, tag("vmem_resident")))
    assert port == ref and len(port) == 3


@pytest.mark.parametrize("seed", [0, 1])
def test_l2_cliff_is_vmem_cliffs_counterpart(seed):
    """The same lines with the regime's name changed: L2 for VMEM."""
    port = findings.l2_cliff(_curve(
        seed, lambda d, p: "l2_resident" if p < 24 else "hbm_bound"))
    ref = jax_findings.vmem_cliff(_curve(
        seed, lambda d, p: "vmem_resident" if p < 24 else "hbm_bound"))
    assert port == [ln.replace("VMEM", "L2") for ln in ref]
    assert len(port) == 3 and "between 2^23 and 2^24" in port[0]


def _averages(seed):
    rng = _rng(seed)
    return {key: float(rng.uniform(20, 4000))
            for key in report.REFERENCE_SINGLE_GPU}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_multiples_match_jax(seed):
    sc = _averages(seed)
    sc[("INT", "MIN")] = 45.0     # one below the reference
    assert findings.reference_multiples(sc, report.REFERENCE_SINGLE_GPU) \
        == jax_findings.reference_multiples(sc,
                                            jax_report.REFERENCE_SINGLE_GPU)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_collective_crossover_matches_jax(seed):
    rng = _rng(seed)
    sc = {("INT", "SUM"): 100.0, ("DOUBLE", "MAX"): 80.0}
    coll = {(dt, op, r): float(rng.uniform(10, 200))
            for dt, op in sc for r in (2, 4, 8, 16)}
    assert findings.collective_crossover(coll, sc) \
        == jax_findings.collective_crossover(coll, sc)


def test_derive_findings_matches_jax_without_regime_tags():
    rows = _curve(4, None)
    rows[3]["status"] = "RECOVERED"
    sc, coll = _averages(4), {("INT", "SUM", 4): 9e9}
    assert findings.derive_findings(rows, sc, coll,
                                    report.REFERENCE_SINGLE_GPU) \
        == jax_findings.derive_findings(rows, sc, coll,
                                        jax_report.REFERENCE_SINGLE_GPU)


# ---------------------------------------------------------------------------
# plot
# ---------------------------------------------------------------------------


@pytest.fixture
def no_matplotlib(monkeypatch):
    """Import of matplotlib fails, as on a host without it (the JAX
    package's own test of the fallback does the same)."""
    real_import = builtins.__import__

    def no_mpl(name, *a, **k):
        if name.startswith("matplotlib"):
            raise ImportError(name)
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_mpl)


def _shmoo_rows(seed=0):
    return [{k: r[k] for k in ("dtype", "method", "n", "gbps")}
            for r in _curve(seed, None)]


def _texts(paths):
    """{file name: text} of each written file, and of the .dat files a
    gnuplot script names."""
    out = {}
    for p in paths:
        out[p.name] = p.read_text()
        for dat in sorted(p.parent.glob(f"{p.stem}_*.dat")):
            out[dat.name] = dat.read_text()
    return out


def test_plot_vs_n_fallback_text_matches_jax(tmp_path, no_matplotlib):
    rows = _shmoo_rows()
    hl = {"reference CUDA int SUM (90.8)": 90.8413,
          "H100 HBM roof (3350)": 3350.0}
    for name in ("port", "jax"):
        (tmp_path / name).mkdir()
    port = plot.plot_vs_n(rows, tmp_path / "port" / "vs_n", title="t",
                          hlines=hl)
    ref = jax_plot.plot_vs_n(rows, tmp_path / "jax" / "vs_n", title="t",
                             hlines=hl)
    assert [p.suffix for p in port] == [".dat"]
    assert _texts(port) == _texts(ref)
    assert "# hline H100 HBM roof (3350) 3350.000" in port[0].read_text()


def test_rank_plots_fallback_text_matches_jax(tmp_path, no_matplotlib):
    """plot_vs_ranks' gnuplot script and .dat files, plot_scaling_shape's
    and plot_vn_vs_co's .dat files: equal text."""
    rng = _rng(2)
    avgs = {(dt, op, r): float(rng.uniform(1, 100)) for dt in ("INT",)
            for op in ("SUM", "MIN", "MAX") for r in (2, 4, 8)}
    shape = {"a": [(2, 4.0), (4, 6.0), (8, 7.0)], "b": [(2, 0.0)]}
    got = {}
    for name, mod in (("port", plot), ("jax", jax_plot)):
        d = tmp_path / name
        d.mkdir()
        got[name] = _texts(
            list(mod.plot_vs_ranks(avgs, "INT", d / "int",
                                   single_chip_lines={"one card": 90.84}))
            + list(mod.plot_scaling_shape(shape, d / "shape"))
            + list(mod.plot_vn_vs_co({"VN": avgs, "CO": {}}, "INT", "SUM",
                                     d / "vn_vs_co")))
    assert got["port"] == got["jax"]
    assert {"int.gp", "int_SUM.dat", "shape.dat",
            "vn_vs_co.dat"} <= set(got["port"])


def test_plot_vs_n_renders_png_and_eps(tmp_path):
    outs = plot.plot_vs_n(_shmoo_rows(), tmp_path / "vs_n",
                          hlines={"roof": 3350.0})
    assert sorted(p.suffix for p in outs) == [".eps", ".png"]
    assert all(p.stat().st_size > 0 for p in outs)


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_row_builders_match_jax(seed):
    sc = _averages(seed)
    del sc[("DOUBLE", "MIN")]          # a missing cell stays missing
    rng = _rng(seed)
    coll = {(dt, op, r): float(rng.uniform(1, 9)) for dt, op in sc
            for r in (2, 8)}
    assert report.build_sc_rows(sc) == jax_report.build_sc_rows(sc)
    assert report.build_sc_rows(None) == jax_report.build_sc_rows(None)
    assert report.build_coll_rows(coll) == jax_report.build_coll_rows(coll)


@pytest.mark.parametrize("cal", [
    None,
    {"platform": "cpu", "block_awaits_execution": True},
    {"platform": "tpu", "block_awaits_execution": False,
     "single_blocked_s": 2e-4, "chained_per_iter_s": 3e-5}])
def test_build_notes_match_jax_but_the_f64_note(cal):
    """Note 1 (float64's route) is the port's own: native f64 on the
    card, --f64=dd for the pair route."""
    port, ref = report.build_notes(cal), jax_report.build_notes(cal)
    assert len(port) == len(ref)
    assert [n for i, n in enumerate(port) if i != 1] \
        == [n for i, n in enumerate(ref) if i != 1]
    assert port[1].startswith("float64 runs natively on the card")
    assert "float64 on TPU" in ref[1]


# the report.md lines the port changes on purpose (on the JAX side) and
# adds (on the port's), named one by one
JAX_ONLY_LINES = {
    "# TPU Reduction Benchmarks — generated report",
    "*Generated <date> by tpu_reductions.bench.report (the writeup.tex "
    "analog).*",
    "(mpi/CUdata.txt); this framework measures one TPU chip with the Pallas",
    "kernel path at the same n.",
    "- float64 on TPU uses the double-double / order-key 32-bit-pair paths; "
    "wire bytes per element are identical to native f64.",
}
PORT_ONLY_LINES = {
    "# GPU Reduction Benchmarks — generated report",
    "*Generated <date> by tpu_reductions_torch.bench.report (the "
    "writeup.tex analog).*",
    "(mpi/CUdata.txt); this framework measures one card with the "
    "hand-written",
    "CUDA kernel path at the same n.",
    "",
    "Device: NVIDIA H100 80GB HBM3, 700.00 W.",
    "- float64 runs natively on the card (8 bytes per element); --f64=dd "
    "takes the double-double / order-key 32-bit-pair route instead, with "
    "the same bytes per element.",
}


def _masked(md: str):
    today = datetime.date.today().isoformat()
    return md.replace(f"Generated {today} by", "Generated <date> by") \
        .splitlines()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("with_coll", [False, True])
def test_report_md_matches_jax_but_named_lines(tmp_path, seed, with_coll):
    """The same data through both generate_report: report.md equal line
    for line, the date masked, apart from the named lines; report.tex
    written too."""
    sc = _averages(seed)
    rng = _rng(seed)
    coll = ({(dt, op, r): float(rng.uniform(1, 200)) for dt, op in sc
             for r in (2, 4)} if with_coll else {})
    cal = {"platform": "gpu", "block_awaits_execution": True}
    figs = [tmp_path / "bandwidth_vs_n.png", tmp_path / "bandwidth_vs_n.eps"]
    ann = roofline.annotate(_curve(seed, None), "NVIDIA H100 80GB HBM3")
    jax_ann = [dict(r, regime=r["regime"].replace("l2_", "vmem_"))
               for r in ann]
    kwargs = dict(single_chip=sc, figures=figs, platform="gpu",
                  calibration=cal, roofline=["a roofline line ^ 2^24"])
    port = report.generate_report(coll, out_dir=tmp_path / "port",
                                  annotated_rows=ann,
                                  device="NVIDIA H100 80GB HBM3, 700.00 W",
                                  **kwargs)
    ref = jax_report.generate_report(coll, out_dir=tmp_path / "jax",
                                     annotated_rows=jax_ann, **kwargs)
    a = _masked(port["md"].read_text())
    b = [ln.replace("VMEM", "L2") for ln in _masked(ref["md"].read_text())]
    removed, added = set(), set()
    for line in difflib.ndiff(b, a):
        if line.startswith("- "):
            removed.add(line[2:])
        elif line.startswith("+ "):
            added.add(line[2:])
    assert removed == JAX_ONLY_LINES
    assert added == PORT_ONLY_LINES
    tex = port["tex"].read_text()
    assert "Device: NVIDIA H100 80GB HBM3, 700.00 W." in tex
    assert "2^24" not in tex and "textasciicircum" in tex


def test_report_without_calibration_or_device(tmp_path):
    """The port passes no calibration yet: no calibration note, and the
    device line says it was not recorded."""
    paths = report.generate_report({}, single_chip=_averages(0),
                                   out_dir=tmp_path)
    md = paths["md"].read_text()
    assert "Timing calibration" not in md
    assert "Device: not recorded." in md
    assert "chained slope timing" in paths["tex"].read_text()


def test_report_cli_regenerates_from_single_chip_cells(tmp_path, capsys):
    sc_raw = tmp_path / "single_chip" / "raw_output"
    sc_raw.mkdir(parents=True)
    for rep, g in enumerate((200.0, 300.0)):
        (sc_raw / f"run-int32-SUM-{rep}.json").write_text(json.dumps(
            {"method": "SUM", "dtype": "int32", "gbps": g,
             "status": "PASSED"}) + "\n")
    (sc_raw / "run-int32-MIN-0.json").write_text(json.dumps(
        {"method": "MIN", "dtype": "int32", "gbps": 9.0,
         "status": "FAILED"}) + "\n")
    (tmp_path / "device.txt").write_text("NVIDIA H100 80GB HBM3, 700.00 W\n")
    assert report.main([str(tmp_path)]) == 0
    md = (tmp_path / "report.md").read_text()
    assert "| INT | SUM | 90.8413 | 250.0000 | 2.75x |" in md
    assert "| INT | MIN | 90.7905 | — | — |" in md
    assert "Device: NVIDIA H100 80GB HBM3, 700.00 W." in md
    with pytest.raises(SystemExit):
        report.main([str(tmp_path / "nope")])


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("dtype, p, regime, working_set", [
    ("int32", 23, "l2_resident", 32 << 20),    # 32 MiB <= 50 MiB
    ("int32", 24, "hbm_bound", 64 << 20),      # 64 MiB > 50 MiB
    ("bfloat16", 23, "l2_resident", 16 << 20),
    ("bfloat16", 24, "l2_resident", 32 << 20),
    ("bfloat16", 25, "hbm_bound", 64 << 20),
    ("float64", 22, "l2_resident", 32 << 20),
    ("float64", 23, "hbm_bound", 64 << 20),
])
def test_roofline_regimes_on_h100(dtype, p, regime, working_set):
    """Hand-computed: working set n x itemsize against the 50 MiB L2;
    an HBM-bound row's fraction is its GB/s over 3350."""
    row = {"dtype": dtype, "method": "SUM", "n": 1 << p, "gbps": 2345.0,
           "status": "PASSED"}
    ann, = roofline.annotate([row], device_kind=H100)
    assert ann["working_set_bytes"] == working_set
    assert ann["regime"] == regime and ann["device_kind"] == H100
    if regime == "hbm_bound":
        assert ann["hbm_fraction"] == 2345.0 / 3350.0
    else:
        assert "hbm_fraction" not in ann


def test_roofline_unknown_kind_keeps_its_label_and_summary_lines():
    rows = [{"dtype": "int32", "method": "SUM", "n": 1 << p,
             "gbps": float(100 * p)} for p in (20, 23, 24, 28)]
    ann = roofline.annotate(rows, device_kind="NVIDIA A100-SXM4-80GB")
    assert {r["device_kind"] for r in ann} == {"NVIDIA A100-SXM4-80GB"}
    assert [r["regime"] for r in ann] == ["l2_resident"] * 2 \
        + ["hbm_bound"] * 2
    lines = roofline.summarize(ann)
    assert lines[0] == ("Device: NVIDIA A100-SXM4-80GB; HBM roof 3350 "
                        "GB/s; L2-residency bound 50 MiB.")
    assert lines[1] == ("int32 SUM: HBM-bound peak 2800.0 GB/s = 84% of "
                        "the roof (n=2^28)")
    assert lines[2].startswith("int32 SUM: L2-resident peak 2300.0 GB/s "
                               "(n=2^23;")
    assert roofline.annotate(rows)[0]["device_kind"] == H100
    ann[0]["status"] = "RECOVERED"
    assert roofline.summarize(ann)[-1].startswith("CAVEAT: 1 of 4")


# ---------------------------------------------------------------------------
# pdf, stream table
# ---------------------------------------------------------------------------


def _pdf_data(tmp_path):
    png = plot.plot_vs_n(_shmoo_rows(), tmp_path / "bandwidth_vs_n")
    ann = roofline.annotate(_curve(0, None), H100)
    return {"avgs": {}, "single_chip": _averages(0), "calibration": None,
            "figures": list(png), "roofline": roofline.summarize(ann),
            "annotated_rows": ann, "device": f"{H100}, 700.00 W"}


def test_pdf_is_written_with_matplotlib(tmp_path):
    path = pdf.generate_pdf(tmp_path, data=_pdf_data(tmp_path))
    data = path.read_bytes()
    assert path == tmp_path / "writeup.pdf" and data[:5] == b"%PDF-"
    assert data.count(b"/Type /Page ") >= 3    # tables, analysis, figure


def test_pdf_skips_with_a_note_without_matplotlib(tmp_path, monkeypatch,
                                                  capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert pdf.generate_pdf(tmp_path) is None
    assert "writeup skipped (no matplotlib)" in capsys.readouterr().out
    assert not (tmp_path / "writeup.pdf").exists()


def test_pdf_cli_on_an_experiment_dir(tmp_path):
    shutil.copytree(DEMO_RAW.parent / "single_chip",
                    tmp_path / "single_chip")
    out = tmp_path / "w.pdf"
    assert pdf.main([str(tmp_path), f"--out={out}"]) == 0
    assert out.read_bytes()[:5] == b"%PDF-"


def _probe(method, n, final_fields):
    rows = [{"chunk": 0, "partial": 1.0},
            dict({"final": True, "num_chunks": 4, "gbps_sustained": 19.8,
                  "chunks_per_s": 75.1, "status": "PASSED"},
                 **final_fields)]
    return {"method": method, "dtype": "int32", "n": n, "complete": True,
            "rows": rows}


@pytest.mark.parametrize("probes", [
    {},
    {"stream_probe": _probe("SUM", 1 << 28, {"overlap_efficiency": 1.52})},
    {"stream_probe": _probe("SUM", 1 << 28, {}),
     "stream_hazard": _probe("MAX", 1 << 30, {"overlap_efficiency": 0.9}),
     "broken": [1, 2], "unfinished": {"rows": [{"chunk": 0}]}},
])
def test_stream_markdown_matches_jax(probes):
    assert stream.stream_markdown(probes) == jax_stream.stream_markdown(probes)
