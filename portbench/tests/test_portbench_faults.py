"""A run on the CPU with the timed path broken underneath comes out not
correct: once for each fault these cells can have (a step that returns its
state unchanged, half of the batch left out, an answer altered where it is
produced; no cell spans chips), and for two-image jobs a wrong bootstrap.
The run is ``run.measure`` as the card's runs drive it, on throwaway cells
at a size a test run holds (5 views, or views 1-2, of 240x320, 600
keypoints), whose limits are set from this size's sound readings
(reprojection 0.11-0.12 px, outliers 0.2-0.9%, worst rotation 2.1 deg; the
faults read 0.40-0.60 px, 17-20% and 29% of matches off; two images: image
1 at 0.79-1.83 px and 0.6-1.4% of observations behind, against 4.3-6.1 px
and 98.6-99.5% under the bootstrap's faults)."""

import json
import os
import shutil

import pytest
import torch

from portbench import control, jobs as J, run as R
from portbench.spec import Bench

from test_portbench_layout import PB, ROOT

TINY_LIMITS = {"kp_off": 0.001, "match_off": 0.01, "epi_bad": 0.05, "rot_deg": 5.0,
               "ate_rel": 0.5, "reproj_px": 0.3}


PAIR_LIMITS = {"kp_off": 0.001, "match_off": 0.01, "reproj_med_px": 0.3, "behind_share": 0.1,
               "image1_med_px": 3.0}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = tmp_path_factory.mktemp("bench")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), d / "BENCHMARK.json")
    shutil.copytree(PB, d / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    doc = json.loads((d / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "tiny_upstream", "source": "a test size",
                           "file": "portbench/configs/tiny_upstream.json", "reduced": [],
                           "why": "test"})
    doc["workloads"].append({"name": "tiny_inc5", "config": "tiny_upstream", "traffic": "tiny5",
                             "chips": 1, "why": "test"})
    (d / "BENCHMARK.json").write_text(json.dumps(doc))
    cfg = json.loads((d / "portbench/configs/incremental_upstream.json").read_text())
    cfg.update(name="tiny_upstream", image_hw=[240, 320], f=400.0)
    cfg["extractor"]["num_interest_points"] = 600
    (d / "portbench/configs/tiny_upstream.json").write_text(json.dumps(cfg))
    cell = json.loads((d / "portbench/workloads/inc10_bench.json").read_text())
    cell.pop("scene_seed", None)        # scenes from the run's seed
    cell.update(traffic="tiny5", views=5, pool=1, check_jobs=4, limits=TINY_LIMITS)
    cell["render"].update(num_views=5, num_points=150)
    (d / "portbench/workloads/tiny_inc5.json").write_text(json.dumps(cell))
    doc = json.loads((d / "BENCHMARK.json").read_text())
    doc["workloads"].append({"name": "tiny_pairs", "config": "tiny_upstream", "traffic": "tiny2",
                             "chips": 1, "why": "test"})
    (d / "BENCHMARK.json").write_text(json.dumps(doc))
    cell = json.loads((d / "portbench/workloads/inc2_pairs.json").read_text())
    cell.update(traffic="tiny2", pool=1, check_jobs=4, limits=PAIR_LIMITS)
    cell["render"].update(num_points=150)
    (d / "portbench/workloads/tiny_pairs.json").write_text(json.dumps(cell))
    return Bench(str(d))


def _measure(bench, tmp_path, cell="tiny_inc5"):
    import time

    res, table = R.measure(bench, cell, 2 ** 31 + 99, 0.01, False, torch.device("cpu"),
                           lambda: None, "cpu", time.perf_counter(), str(tmp_path))
    return res, table


def test_a_sound_run_is_correct(tiny, tmp_path):
    res, table = _measure(tiny, tmp_path)
    assert res["correct"], table
    assert res["attempted"] == 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"frames_per_s", "peak_device_gib", "setup_s"}


@pytest.mark.parametrize("fault", control.PROGRAM_FAULTS)
def test_a_fault_in_the_program_makes_the_run_not_correct(tiny, tmp_path, fault):
    with control.planted(fault):
        res, table = _measure(tiny, tmp_path)
    assert not res["correct"], (fault, table)


@pytest.mark.parametrize("fault", control.OUTPUT_FAULTS)
def test_an_answer_altered_where_it_is_produced_makes_the_run_not_correct(
        tiny, tmp_path, fault, monkeypatch):
    real = J.run_job
    monkeypatch.setattr(J, "run_job", lambda *a, **kw: control.alter(real(*a, **kw), fault))
    res, table = _measure(tiny, tmp_path)
    assert not res["correct"], (fault, table)


def test_a_sound_two_image_run_is_correct(tiny, tmp_path):
    res, table = _measure(tiny, tmp_path, "tiny_pairs")
    assert res["correct"], table


@pytest.mark.parametrize("fault", control.BOOTSTRAP_FAULTS)
def test_a_wrong_bootstrap_makes_a_two_image_run_not_correct(tiny, tmp_path, fault):
    """The decomposition that cheirality rejects (caught by ``behind_share``)
    and camera 1's pose for camera 2 (caught by ``image1_med_px``): both
    reproject onto image 2 as well as a sound run does."""
    with control.planted(fault):
        res, table = _measure(tiny, tmp_path, "tiny_pairs")
    assert not res["correct"], (fault, table)
    assert table["reproj_med_px"]["value"] <= PAIR_LIMITS["reproj_med_px"], table
