"""Stage-3 losses (port of texgs/losses): plain PyTorch, as they are plain
XLA in texgs."""

from .normal import norm_from_depth, norm_loss, norm_reg_loss
from .pixelwise import l1_loss, l2_loss
from .smooth import smooth_loss
from .ssim import ssim_loss
from .zero_one import zero_one_loss

__all__ = ["l1_loss", "l2_loss", "ssim_loss", "smooth_loss", "norm_loss",
           "norm_from_depth", "norm_reg_loss", "zero_one_loss"]
