"""Kernel K5'' (``hash_encode_backward``): what the encode's VJP must move
and do for one call's queries.

Bytes: each query's point and its cotangent (L x F) read and its point
gradient written (the cell's queries need it: the uvs come from the UV
net), the table read and its gradient written once.  Operations, a query
and level: the forward's 12 and, a corner, its 11 (hash and weight); then
the weighted cotangent added to the table (2F: a product and an atomic
add a feature), its dot with the corner's row (2F) and the weight's three
partial products into the fraction's gradient (6); the gradient scaled
by the resolution (3)."""


def count(c: dict) -> tuple[float, float]:
    n, lv, f = c["n_enc"], c["n_levels"], c["n_features"]
    n_bytes = n * (3 + lv * f + 3) * 4 + 2 * lv * c["table_size"] * f * 4
    return n_bytes, n * lv * (12 + 3 + 8 * (11 + 4 * f + 6))
