"""Kernel K5' (``hash_encode_forward``): what the encode must move and do
for one call's queries (the step's inverse points and sphere samples).

Bytes: each query's point (3 floats) read and its L x F features
written once, the (L, T, F) table read once.  Operations, a query and
level: the grid position, its floor, the fraction and one minus it (12);
a corner: its 3 offsets, 3 prime products, 2 xors and the table modulus
(9), the weight's 2 products and F multiply-adds (2F)."""


def count(c: dict) -> tuple[float, float]:
    n, lv, f = c["n_enc"], c["n_levels"], c["n_features"]
    n_bytes = n * (3 + lv * f) * 4 + lv * c["table_size"] * f * 4
    return n_bytes, n * lv * (12 + 8 * (11 + 2 * f))
