"""A run without a CUDA device, or in a directory that holds only the
benchmark, exits non-zero and prints no result."""

import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness


def _run(cwd, workload):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", workload,
         "--seed", "4294967311", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("w", [w["name"] for w in harness.manifest()["workloads"]])
def test_no_card_no_result(w):
    out = _run(harness.ROOT, w)
    assert out.returncode != 0
    assert "correct" not in out.stdout


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, harness.manifest()["workloads"][0]["name"])
    assert out.returncode != 0
    assert "correct" not in out.stdout
