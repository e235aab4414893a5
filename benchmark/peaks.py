"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W
limit), and the bound of a function from what it must move and do.  The
port computes in float32 with TF32 off, so the float32 rate outside the
tensor cores is the one peak of its arithmetic."""

F32_FLOPS = 67e12        # float32, CUDA cores
HBM_BYTES_PER_S = 3.35e12


def bound_s(n_bytes: float, flops: float) -> float:
    """The least time the card could take: max(bytes / HBM rate, float32
    operations / float32 peak)."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS)
