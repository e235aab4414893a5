"""The frozen counts at the flagship shape (100,000 Gaussians, 800x600:
1,900 tiles, m = 32, F = 10, 360,514 pairs) against the figures the
chip_smoke.py runs printed (PERF.md, kernel table): A 291.0 MB, A' 248.6
MB and 7.063 GFLOP, B 308.5 MB, B' 524.2 MB.  Those runs printed no live
slot or touched-texel count; the live slots come from B''s 26.9 M vector
atomics (four taps a live slot), the texels are held to what a 1024^2
cubemap has, and A''s operations take every pair at every pixel of its
tile (the stop rule ends few)."""

import pytest

from benchmark import harness, peaks

FLAGSHIP = {"n": 100_000, "n_f": 10, "m": 32, "n_tiles": 50 * 38,
            "n_pairs": 360_514, "height": 600, "width": 800, "tex_res": 1024,
            "sh_degree": 3, "mlp_width": 128, "n_inv": 0}
LIVE = 26.9e6 / 4
MAX_TEXELS = 6 * 1024 * 1024


def count(fn, **kw):
    return harness.load_module("counts", fn).count({**FLAGSHIP, **kw})


def test_kernel_a_bytes():
    b, _ = count("uvtex_fused", n_eval=0, live=0, texels=0)
    assert b / 1e6 == pytest.approx(291.0, abs=0.05)


def test_kernel_a_prime():
    b, f = count("uvtex_fused_bwd", n_eval=FLAGSHIP["n_pairs"] * 256,
                 live=LIVE, texels=0)
    assert b / 1e6 == pytest.approx(248.6, abs=0.5)
    assert f / 1e9 == pytest.approx(7.063, rel=2e-3)


def test_kernel_b_and_b_prime_bytes():
    lo, _ = count("tex_term", n_eval=0, live=LIVE, texels=0)
    hi, _ = count("tex_term", n_eval=0, live=LIVE, texels=MAX_TEXELS)
    assert lo / 1e6 < 308.5 < hi / 1e6
    lo, _ = count("tex_term_bwd", n_eval=0, live=LIVE, texels=0)
    hi, _ = count("tex_term_bwd", n_eval=0, live=LIVE, texels=MAX_TEXELS)
    assert lo / 1e6 < 524.2 < hi / 1e6


def test_stage3_step_matches_roofline_formula():
    # tools/roofline.py at its flagship (500,000 pairs) with the inverse
    # term over 8,192 points: 100.35 GFLOP a step at 360,514 pairs
    # (PERF.md section 5), and the forward-only frame a part of it
    _, f = count("stage3_step", n_pairs=360_514, n_inv=8192, n_eval=0,
                 live=0, texels=0)
    assert f / 1e9 == pytest.approx(100.35, abs=0.05)
    _, fv = count("view_frame", n_eval=0, live=0, texels=0)
    assert 0.3 * f < fv < f


def test_bound_takes_the_larger_time():
    assert peaks.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 67e12) == pytest.approx(1.0)
    assert peaks.bound_s(3.35e12, 134e12) == pytest.approx(2.0)
