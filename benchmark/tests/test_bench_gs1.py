"""The stage-1 cell's modules: the reference, the quantities and the
driver import neither JAX nor the JAX package, and the reference imports
nothing of the program (each in a process of its own, as
test_bench_imports.py checks).  On the card, at the cell's own size, on
three seeds: the program comes out correct, and the control (the
reference with TF32 on) and each fault (half of each view out of the
loss, a frozen Adam, SH held at degree 0) do not.  The card test skips
without a card.

    python -m pytest -p no:cacheprovider --noconftest -o addopts="" \\
        -m cuda -q benchmark/tests/test_bench_gs1.py
"""

import pytest
import torch

from benchmark import harness
from benchmark.tests.test_bench_imports import loaded

SEEDS = (2718281829, 3141592653, 1618033989)


def test_gs1_modules_load_no_jax():
    imports = ("import benchmark.reference.stage1, benchmark.quantities_gs1, "
               "benchmark.scene_gs1, benchmark.metrics_spans, "
               "benchmark.drivers.gs1_train_loop")
    assert loaded(imports, harness.FORBIDDEN) == []


def test_stage1_reference_imports_nothing_of_the_program():
    imports = ("import benchmark.reference.stage1, benchmark.quantities_gs1, "
               "benchmark.scene_gs1")
    assert loaded(imports, harness.FORBIDDEN + ("texgs_torch",)) == []


@pytest.mark.cuda
def test_gs1_control_and_faults_are_not_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import texgs_torch  # noqa: F401
    from benchmark.tests import calibrate_gs1
    limits = harness.cell("gs1-dtu-train")["work"]["limits"]
    for seed in SEEDS:
        for kind, nums in calibrate_gs1.readings(
                seed, "cuda", control=True, faults=tuple(calibrate_gs1.FAULTS)):
            comp, correct = harness.verdict(nums, limits)
            assert correct == (kind == "program"), (seed, kind, comp)
