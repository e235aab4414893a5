"""One stage-2 training step's FLOPs and bytes, from shapes: the UV net
on the inverse points and on the inverse-mapped sphere samples, the
inverse net on both in one batch, each forward and backward; the hash
encode and its VJP (``counts/hash_encode{,_bwd}.py``); the chamfer's
distance of each (sample, cloud point) pair.

A net's layer of (in, out) on n rows: 2 n in out FLOPs forward and twice
that backward (the input's and the weight's gradients); its input read
and output written forward, and both again with their gradients
backward.  The chamfer: one squared distance a pair (3 differences, 3
squares, 2 adds), which both directions share, and its comparison in
each (2); both clouds read once a direction.  Adam's and the losses'
elementwise work is under a thousandth of this and left out."""

from benchmark import harness


def _net(layers, n: int) -> tuple[float, float]:
    flops = sum(6 * n * a * b for a, b in layers)
    n_bytes = sum(3 * n * (a + b) * 4 for a, b in layers)
    return n_bytes, flops


def count(c: dict) -> tuple[float, float]:
    parts = [_net(c["uv_layers"], c["n_points"] + c["n_samples"]),
             _net(c["inv_layers"], c["n_enc"])]
    for fn in ("hash_encode", "hash_encode_bwd"):
        parts.append(harness.load_module("counts", fn).count(c))
    pairs = c["n_samples"] * c["n_pcd"]
    parts.append((2 * 2 * (c["n_samples"] + c["n_pcd"]) * 3 * 4,
                  10 * pairs))
    return sum(p[0] for p in parts), sum(p[1] for p in parts)
