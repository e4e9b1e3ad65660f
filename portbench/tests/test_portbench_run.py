"""``run.py`` refuses to measure where it cannot: no card, or no program."""

import os
import shutil
import subprocess
import sys

import pytest

from test_portbench_layout import PB, ROOT

ARGS = ["--workload", "inc10_bench", "--seed", "3", "--seconds", "1", "--trace", "0"]


def _run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "portbench/run.py", *ARGS], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_without_a_card_it_exits_non_zero_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    r = _run(ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_with_only_the_benchmark_files_it_exits_non_zero_and_prints_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    shutil.copytree(PB, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(str(tmp_path))
    assert r.returncode != 0 and r.stdout.strip() == ""
