"""The stage-1 system under test, built from the benchmark's state: the
program's ``Gaussian3D``.  Beside ``program.py``, the only module of the
harness that imports the program (``texgs_torch``), and only inside
functions."""

from __future__ import annotations

from benchmark.scene_gs1 import LEAVES


def build_model(cfg: dict, state: dict, hyper: dict, device):
    """The program's stage-1 model through its own constructor,
    ``bind_train_cfg`` and ``setup_optim``, holding copies of ``state``,
    its Adam at ``hyper``'s count on every leaf (zero moments)."""
    from texgs_torch.config import Cfg
    from texgs_torch.core.state import GaussianState
    from texgs_torch.train.gaussian3d import Gaussian3D

    model = Gaussian3D(Cfg(cfg["model_cfg"]), device=device)
    model.bind_train_cfg(Cfg(cfg["train_cfg"]),
                         cfg["dataset_cfg"]["background"])
    model.state = GaussianState.from_params(
        {k: state[k].clone() for k in LEAVES})
    model.active_sh_degree = int(hyper["active_sh_degree"])
    model.spatial_lr_scale = float(hyper["spatial_lr_scale"])
    model.setup_optim(Cfg(cfg["optim_cfg"]))
    for k in model.adam.count:
        model.adam.count[k] = int(hyper["adam_count"])
    return model


def leaves(model) -> dict:
    return model.state.params_dict()


def moments(model) -> dict:
    return model.adam.mu


def kernel_functions():
    """The functions whose device work a roofline share reads, by the name
    the share uses: {name: (module, attribute)}."""
    from texgs_torch.kernels import raster
    return {"raster": (raster, "raster_pairs_forward"),
            "raster_bwd": (raster, "raster_pairs_backward")}
