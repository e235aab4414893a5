"""Kernel 1 (``raster_pairs_forward``): what it must move and do, from the
call's quantities (chip_smoke.py's stage-1 bound).

Bytes: the Gaussian table (16 + F - 7 columns), the pair list (int32)
with each tile's start and end, and its outputs written once: the blend
(T, 256, F), T_final and the evaluated-pair counts.  Operations: 16 + 2F
per evaluated (pixel, pair)."""

OPS_EVAL = 16


def count(c: dict) -> tuple[float, float]:
    px = c["n_tiles"] * 256
    table = c["n"] * (16 + c["n_f"] - 7) * 4
    n_bytes = (table + c["n_pairs"] * 4 + c["n_tiles"] * 8
               + px * c["n_f"] * 4 + px * 4 + px * 4)
    return n_bytes, c["n_eval"] * (OPS_EVAL + 2 * c["n_f"])
