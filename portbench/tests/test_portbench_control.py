"""The control on the card, at a size a test run holds: the reference front
end put in the program's place with TF32 on reads farther from the float32
reference than the program does, and every fault comes out beyond the
program's sound reading. The cell-size readings that set the limits come
from ``portbench/control.py`` on the card (PERF.md)."""

import json
import os
import shutil

import pytest

from portbench import control
from portbench.spec import Bench

from test_portbench_layout import PB, ROOT


@pytest.mark.card
def test_control_and_faults_read_beyond_the_program(card, tmp_path):
    import torch

    d = tmp_path / "bench"
    d.mkdir()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), d / "BENCHMARK.json")
    shutil.copytree(PB, d / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    cell = json.loads((d / "portbench/workloads/inc10_bench.json").read_text())
    cell.update(views=5, pool=1)
    cell["render"]["num_views"] = 5
    (d / "portbench/workloads/inc10_bench.json").write_text(json.dumps(cell))
    rows = []
    control.readings(Bench(str(d)), "inc10_bench", [21, 22, 23], 1,
                     ("control",) + control.PROGRAM_FAULTS + ("bootstrap_flipped",)
                     + control.OUTPUT_FAULTS, card,
                     lambda: torch.cuda.synchronize(card), str(tmp_path / "scenes"),
                     emit=rows.append)
    sound = [r for r in rows if r["variant"] == "sound"]
    assert sound and not any(r["failed"] for r in sound)
    worst = {k: max(r[k] for r in sound)
             for k in ("match_off", "reproj_px", "epi_bad", "behind_share")}
    assert all(r["match_off"] > worst["match_off"] for r in rows if r["variant"] == "control")
    by = {v: [r for r in rows if r["variant"] == v]
          for v in control.PROGRAM_FAULTS + ("bootstrap_flipped",) + control.OUTPUT_FAULTS}
    assert all(r["failed"] or r["reproj_px"] > worst["reproj_px"] for r in by["ba_unchanged"])
    assert all(r["failed"] or r["epi_bad"] > worst["epi_bad"] for r in by["filter_unchanged"])
    assert all(r["failed"] for r in by["half_left_out"])
    assert all(r["failed"] or r["behind_share"] > worst["behind_share"]
               for r in by["bootstrap_flipped"])
    assert all(r["reproj_px"] > worst["reproj_px"] for r in by["pose_altered"])
    assert all(r["match_off"] > worst["match_off"] for r in by["match_altered"])
