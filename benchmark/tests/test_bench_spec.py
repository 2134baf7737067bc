"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name."""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys

import pytest

from benchlib import spec

DOC = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in DOC["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves_its_files_by_name(workload):
    cell = spec.load_cell(workload)
    assert cell.config["name"] == cell.config_name
    assert cell.traffic["entry"] in ("process_batch", "process",
                                     "step_batch")
    assert set(cell.traffic["check"]["require"]) <= set(cell.limits)
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]).read)
    names = {m["name"] for m in cell.end_to_end}
    assert {"setup_s", "fps"} <= names and cell.per_layer


def test_names_and_units():
    named = [c["name"] for c in DOC["configs"]] + CELLS + \
        [m["name"] for m in DOC["end_to_end"] + DOC["per_layer"]] + \
        [w["config"] for w in DOC["workloads"]] + \
        [w["traffic"] for w in DOC["workloads"]] + \
        [k for c in DOC["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in named), named
    metrics = DOC["end_to_end"] + DOC["per_layer"]
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len(set(CELLS)) == len(CELLS)


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    reports = {m["name"]: set(m.get("workloads", CELLS))
               for m in DOC["end_to_end"]}
    for m in DOC["per_layer"]:
        assert m["moves"] in reports, m
        assert set(m.get("workloads", CELLS)) <= reports[m["moves"]], m


def test_contract_shape():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert DOC["paths"] == ["benchmark"]
    for e in DOC["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25 and e["source"] == "host_clock"
    assert any(e["name"] == "setup_s" for e in DOC["end_to_end"])
    runs = 2 + 14 * 24
    assert runs * (DOC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for c in DOC["configs"]:
        assert (spec.ROOT / c["file"]).is_file()
        assert c["file"].startswith("benchmark/")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def test_nothing_imports_jax_or_the_jax_package():
    bad = {"jax", "jaxlib", "flax", "dynamic_visual_slam_tpu",
           "chip_smoke", "scripts"}
    for path in spec.BENCH_DIR.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & bad, (path, tops & bad)


def test_the_reference_imports_nothing_of_the_port():
    for path in (spec.BENCH_DIR / "slamref").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert "dynamic_visual_slam_tpu_torch" not in tops, path
        assert tops <= {"slamref", "torch", "numpy", "math", "functools",
                        "typing", "dataclasses", "json", "__future__",
                        "os", "collections"}, (path, tops)


def test_the_independent_orb_shares_no_code():
    path = spec.BENCH_DIR / "benchlib" / "orb_independent.py"
    tops = {m.split(".")[0] for m in _imports(path)}
    assert tops <= {"torch", "numpy", "math", "functools", "typing",
                    "pathlib", "__future__"}, tops


def test_loading_the_harness_loads_no_jax():
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]];"
            "import run; from benchlib import cell, check, drivers, probes;"
            "import dynamic_visual_slam_tpu_torch.pipeline.slam;"
            "import slamref.pipeline, slamref.semantic.detector;"
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code, str(spec.BENCH_DIR),
                          str(spec.ROOT)], capture_output=True, text=True,
                         timeout=300, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_names_are_compared_whole():
    import run
    mods = {"dynamic_visual_slam_tpu_torch": 1, "jaxtyping": 1,
            "dynamic_visual_slam_tpu_torch.ops": 1}
    assert run.forbidden_modules(mods) == []
    assert run.forbidden_modules({"dynamic_visual_slam_tpu.ops": 1,
                                  "jax": 1}) == ["dynamic_visual_slam_tpu",
                                                 "jax"]


def test_without_a_card_the_run_prints_no_result():
    out = subprocess.run(
        [sys.executable, str(spec.BENCH_DIR / "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=spec.ROOT,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(spec.ROOT / "build")})
    if out.returncode == 0:
        pytest.skip("a CUDA device is visible")
    assert out.returncode == 2 and out.stdout == ""


def test_a_cell_added_by_files_alone(tmp_path):
    from fixture_cell import load
    cell = load(tmp_path, "tiny.replay")
    assert cell.config["overrides"]["camera"]["width"] == 160
    assert [m["name"] for m in cell.per_layer][-1] == "frames_traced"
    assert callable(spec.metric_reader("frames_traced",
                                       cell.bench_dir).read)
