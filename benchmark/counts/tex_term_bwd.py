"""Kernel B' (``tex_term_backward``): what it must move and do, from the
call's quantities (copied from chip_smoke.py's training-step bound).

Bytes: every slot's w (4 B) and the live slots' uv (12 B), the image
cotangent, the touched texels (12 B each), and the M-list cotangent and
the texture gradient each written once.  Operations: 500 per live slot."""

OPS_SLOT = 500


def count(c: dict) -> tuple[float, float]:
    slots = c["n_tiles"] * 256 * c["m"]
    px3 = 3 * c["height"] * c["width"] * 4
    n_bytes = (4 * slots + 12 * c["live"] + px3 + c["texels"] * 12
               + 16 * slots + 6 * c["tex_res"] ** 2 * 3 * 4)
    return n_bytes, c["live"] * OPS_SLOT
