"""BENCHMARK.json against the benchmark's contract, the files it names found
by name, and the import rule of the harness's modules."""

import ast
import json
import os
import re
import shutil

import pytest

from portbench import spec
from portbench.scenes import pool

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PB)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "sfmfromscratch_tpu"}
PROGRAM = "sfmfromscratch_tpu_torch"


def _doc():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _imports(path):
    """Top-level names of every module a file imports (absolute imports)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def _py_files(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_of_the_harness_imports_jax_or_the_jax_package():
    for path in _py_files(PB):
        assert not (_imports(path) & FORBIDDEN), path


def test_top_level_names_are_compared_whole():
    # the program's name begins with the JAX package's and is allowed
    assert PROGRAM.split(".")[0] not in FORBIDDEN
    assert "sfmfromscratch_tpu" in FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for path in _py_files(os.path.join(PB, "reference")):
        assert PROGRAM not in _imports(path), path


def test_benchmark_keys_names_and_units():
    doc = _doc()
    assert set(doc) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert doc["paths"] == ["portbench"] and doc["command"][1] == "portbench/run.py"
    assert 1 <= doc["run_seconds"] <= 51
    names = [c["name"] for c in doc["configs"]] + [w["name"] for w in doc["workloads"]] \
        + [m["name"] for m in doc["end_to_end"] + doc["per_layer"]]
    for n in names:
        assert NAME.match(n), n
    for m in doc["end_to_end"] + doc["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    e2e = {m["name"] for m in doc["end_to_end"]}
    assert {"frames_per_s", "reproj_px", "peak_device_gib", "setup_s"} <= e2e
    for m in doc["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in doc["per_layer"]:
        assert m["moves"] == "frames_per_s" and "bound" not in m
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_file_is_found_by_name():
    doc = _doc()
    bench = spec.Bench(ROOT)
    used = {w["config"] for w in doc["workloads"]}
    assert used == {c["name"] for c in doc["configs"]}
    for c in doc["configs"]:
        cfg = bench.config(c["name"])
        assert c["file"].startswith("portbench/configs/")
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        for k in ("source", "engine", "extractor", "matcher", "ransac", "ba", "image_hw", "f"):
            assert k in cfg, (c["name"], k)
    for w in doc["workloads"]:
        cell = bench.cell(w["name"])
        assert w["chips"] == 1 and cell["traffic"] == w["traffic"]
        assert cell["limits"] and all(v is not None for v in cell["limits"].values())
        pool.check_cell(cell, bench.scenes)      # its generator and imaging steps have files
        cfg = bench.config(w["config"])
        if "num_views" in cfg:
            assert cell["views"] == cfg["num_views"]
        if "intrinsics" in cfg:
            from sfmfromscratch_tpu_torch.geometry.camera import SensorType

            assert cfg["intrinsics"]["camera_sensor"] in SensorType.__members__
            assert cfg["intrinsics"]["exif_focal_mm"] > 0
        # every cell reports setup_s, another end-to-end metric and a per-layer metric
        e2e = {m["name"] for m in bench.metrics_for("end_to_end", w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert bench.metrics_for("per_layer", w["name"])
    for m in doc["per_layer"]:
        assert callable(bench.reader(m["name"]))


def test_an_orbit_is_rendered_at_its_configurations_spacing():
    """A cell that renders an orbit runs the spacing its configuration
    states (``view_step_deg``, from the configuration's source), so no cell
    runs another deployment's spacing under a configuration's name."""
    bench = spec.Bench(ROOT)
    orbits = 0
    for w in _doc()["workloads"]:
        step = bench.cell(w["name"])["render"].get("orbit_step_deg")
        cfg = bench.config(w["config"])
        if step is not None:
            orbits += 1
            assert "view_step_deg" in cfg, w["name"]
        if "view_step_deg" in cfg:
            assert step == cfg["view_step_deg"], (w["name"], step, cfg["view_step_deg"])
    assert orbits


def test_a_new_cell_needs_new_files_and_entries_only(tmp_path):
    """A throwaway cell added in a copy: a workload file and an entry."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    shutil.copytree(PB, tmp_path / "portbench")
    doc = json.loads((tmp_path / "BENCHMARK.json").read_text())
    doc["workloads"].append({"name": "inc5_short", "config": "incremental_upstream",
                             "traffic": "short5", "chips": 1, "why": "five views"})
    doc["per_layer"][0]["workloads"].append("inc5_short")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    cell = json.loads((tmp_path / "portbench/workloads/inc10_bench.json").read_text())
    cell.update(traffic="short5", views=5)
    cell["render"]["num_views"] = 5
    (tmp_path / "portbench/workloads/inc5_short.json").write_text(json.dumps(cell))
    bench = spec.Bench(str(tmp_path))
    assert bench.workload("inc5_short")["traffic"] == "short5"
    assert bench.cell("inc5_short")["views"] == 5
    assert bench.config("incremental_upstream")["engine"] == "SfmEngine"
    assert callable(bench.reader("frontend_ms_per_view"))
    assert [m["name"] for m in bench.metrics_for("per_layer", "inc5_short")] == [
        doc["per_layer"][0]["name"]]
    with pytest.raises(KeyError):
        bench.workload("no_such_cell")


def test_a_cell_that_names_a_generator_or_step_with_no_file_is_rejected():
    bench = spec.Bench(ROOT)
    cell = bench.cell("glob20_ring")
    with pytest.raises(FileNotFoundError):
        pool.check_cell(dict(cell, renderer="render_nowhere"), bench.scenes)
    with pytest.raises(FileNotFoundError):
        pool.check_cell(dict(cell, imaging=[{"step": "degrade_nowhere", "kw": {}}]), bench.scenes)
    with pytest.raises(ValueError):      # a file of the directory that is no generator
        pool.check_cell(dict(cell, renderer="pool"), bench.scenes)
    with pytest.raises(ValueError):
        pool.check_cell(dict(cell, order="reversed"), bench.scenes)
