"""Kernel 1' (``raster_pairs_backward``): what it must move and do, from
the call's quantities (chip_smoke.py's stage-1 bound).

Bytes: the table and the pair list, the blend and T_final with their
cotangents, and the table's gradient written once.  Operations: 40 + 3F
per evaluated (pixel, pair)."""

OPS_EVAL = 40


def count(c: dict) -> tuple[float, float]:
    px = c["n_tiles"] * 256
    table = c["n"] * (16 + c["n_f"] - 7) * 4
    n_bytes = (2 * table + c["n_pairs"] * 4 + c["n_tiles"] * 8
               + 2 * (px * c["n_f"] * 4 + px * 4))
    return n_bytes, c["n_eval"] * (OPS_EVAL + 3 * c["n_f"])
