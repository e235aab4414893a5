"""Plain ReLU MLPs (port of texgs/nets/mlp.py).

n_hidden_layers hidden ReLU layers of width n_neurons and a linear output,
He-initialised.  Layers are ``nn.Linear``, whose weight is the transpose
of texgs's (in, out) matrix.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn


class MLP(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, n_hidden_layers: int,
                 n_neurons: int, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        dims = [in_dim] + [n_neurons] * n_hidden_layers + [out_dim]
        self.layers = nn.ModuleList(
            nn.Linear(d_in, d_out, device=device)
            for d_in, d_out in zip(dims[:-1], dims[1:]))
        with torch.no_grad():
            for lin in self.layers:
                d_in = lin.in_features
                lin.weight.copy_(torch.randn(
                    lin.weight.shape, generator=generator,
                    device=generator.device if generator is not None
                    else device) * math.sqrt(2.0 / d_in))
                lin.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.layers)
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < n - 1:
                x = torch.relu(x)
        return x

    def load_jax_params(self, params: dict) -> None:
        """Copy texgs MLP params {"w": [(in, out)], "b": [(out,)]}."""
        if len(params["w"]) != len(self.layers):
            raise ValueError(f"MLP has {len(self.layers)} layers, params "
                             f"have {len(params['w'])}")
        with torch.no_grad():
            for lin, w, b in zip(self.layers, params["w"], params["b"]):
                w = torch.as_tensor(np.array(w, np.float32))
                if tuple(w.shape) != (lin.in_features, lin.out_features):
                    raise ValueError(f"layer expects ({lin.in_features}, "
                                     f"{lin.out_features}), got {tuple(w.shape)}")
                lin.weight.copy_(w.T)
                lin.bias.copy_(torch.as_tensor(np.array(b, np.float32)))

    def jax_params(self) -> dict:
        """texgs's layout of these weights: {"w": [(in, out)], "b": [(out,)]}
        as numpy arrays (copies)."""
        return {"w": [lin.weight.detach().T.cpu().numpy().copy()
                      for lin in self.layers],
                "b": [lin.bias.detach().cpu().numpy().copy()
                      for lin in self.layers]}
