"""Kernel A (``fused_pairs_forward``): what it must move and do, from the
call's quantities (copied from chip_smoke.py's view-0 bound).

Bytes: the Gaussian table (16 + F - 7 columns) and the uv rows (24), the
pair list (int32) with each tile's start and end, and its outputs written
once: blend (T, 256, F), T_final, the M-lists (T, 256, m, 4) and the
evaluated-pair counts.  Operations: 16 + 2F per evaluated (pixel, pair)
and 60 per live M-list slot."""

OPS_EVAL, OPS_SLOT = 16, 60
UV_COLS = 24


def count(c: dict) -> tuple[float, float]:
    px = c["n_tiles"] * 256
    table = c["n"] * (16 + c["n_f"] - 7) * 4
    n_bytes = (table + c["n"] * UV_COLS * 4 + c["n_pairs"] * 4
               + c["n_tiles"] * 8 + px * c["n_f"] * 4 + px * 4
               + px * c["m"] * 16 + px * 4)
    return n_bytes, c["n_eval"] * (OPS_EVAL + 2 * c["n_f"]) + c["live"] * OPS_SLOT
