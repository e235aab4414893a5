"""One stage-1 training step's FLOPs and bytes (SH evaluation, projection,
binning, the blend at F = 7, the loss, the six-leaf Adam), from shapes:
``counts/stage3_step.py``'s ``stage1_counts`` (texgs's formulas) at the
step's Gaussians, pairs, view and SH degree, summed."""

from benchmark import harness


def count(c: dict) -> tuple[float, float]:
    comps = harness.load_module("counts", "stage3_step").stage1_counts(
        c["n"], c["n_pairs"], c["width"], c["height"], c["sh_degree"])
    return (sum(v["bytes"] for v in comps.values()),
            sum(v["flops"] for v in comps.values()))
