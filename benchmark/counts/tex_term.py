"""Kernel B (``tex_term_forward``): what it must move and do, from the
call's quantities (copied from chip_smoke.py's view-0 bound).

Bytes: the M-lists (T, 256, m, 4), each texel a live slot's seamless
bilinear taps weight nonzero (12 B, read once), and the (3, H, W) term
written.  Operations: 300 per live slot."""

OPS_SLOT = 300


def count(c: dict) -> tuple[float, float]:
    slots = c["n_tiles"] * 256 * c["m"]
    n_bytes = slots * 16 + c["texels"] * 12 + 3 * c["height"] * c["width"] * 4
    return n_bytes, c["live"] * OPS_SLOT
