"""On the card, at each cell's own size, on three seeds: the program comes
out correct, and the control (the reference computed with TF32 on, the
nearest precision below the configuration's float32) does not; in the
training cell the program with half of each view left out of the loss
does not either.  Skips without a card.

    python -m pytest -p no:cacheprovider --noconftest -o addopts="" \\
        -m cuda -q benchmark/tests
"""

import pytest
import torch

from benchmark import harness

SEEDS = (2718281829, 3141592653, 1618033989)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in
                                  harness.manifest()["workloads"]])
def test_control_and_faults_are_not_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import texgs_torch  # noqa: F401
    from benchmark.tests import calibrate
    limits = harness.cell(name)["work"]["limits"]
    train = harness.cell(name)["work"]["driver"] == "train_loop"
    for seed in SEEDS:
        for kind, nums in calibrate.readings(name, seed, "cuda", control=True,
                                             half=train):
            comp, correct = harness.verdict(nums, limits)
            assert correct == (kind == "program"), (seed, kind, comp)
