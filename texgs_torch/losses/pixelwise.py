"""L1/L2 pixel losses (port of texgs/losses/pixelwise.py)."""


def l1_loss(pred, gt):
    return (pred - gt).abs().mean()


def l2_loss(pred, gt):
    return ((pred - gt) ** 2).mean()
