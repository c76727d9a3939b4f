"""Multi-branch fusion (MBF) with the 16 branches stacked into one weight.

Mirrors ``skghoi_tpu.models.mbf.MultiBranchFusion``: the reference's
cardinality-16 MBF (``heads/adamixer_transH_spatial_r50_head.py:431-530``)

    out = relu( sum_k fc3_k( relu( fc1_k(app) * fc2_k(spatial) ) ) )

with ``[K, in, sub]`` stacked weights, computed as two contractions.
``final_relu=False`` is the reference ``MessageMBF``, whose branch sum is
returned raw.  Appearance and spatial inputs broadcast against each other.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor


class MultiBranchFusion(nn.Module):
    def __init__(self, appearance_size: int, spatial_size: int, representation_size: int,
                 cardinality: int = 16, final_relu: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        k = cardinality
        sub = representation_size // k
        if sub * k != representation_size:
            raise ValueError("The given representation size should be divisible by cardinality")
        self.cardinality = k
        self.final_relu = final_relu
        self.compute_dtype = dtype
        self.w1 = nn.Parameter(torch.empty(k, appearance_size, sub))
        self.b1 = nn.Parameter(torch.empty(k, sub))
        self.w2 = nn.Parameter(torch.empty(k, spatial_size, sub))
        self.b2 = nn.Parameter(torch.empty(k, sub))
        self.w3 = nn.Parameter(torch.empty(k, sub, representation_size))
        self.b3 = nn.Parameter(torch.empty(k, representation_size))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator = None) -> None:
        """torch ``nn.Linear`` default init per branch: U(+-1/sqrt(fan_in))."""
        fans = {"w1": self.w1.shape[1], "b1": self.w1.shape[1], "w2": self.w2.shape[1],
                "b2": self.w2.shape[1], "w3": self.w3.shape[1], "b3": self.w3.shape[1]}
        for name, fan_in in fans.items():
            bound = fan_in ** -0.5
            getattr(self, name).uniform_(-bound, bound, generator=generator)

    @staticmethod
    def _branches(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
        """``[..., i] x [K, i, s] -> [..., K, s]`` plus the branch biases."""
        k, i, s = w.shape
        y = x @ w.permute(1, 0, 2).reshape(i, k * s)
        return y.unflatten(-1, (k, s)) + b

    def forward(self, appearance: Tensor, spatial: Tensor) -> Tensor:
        dt = self.compute_dtype
        a = self._branches(appearance.to(dt), self.w1.to(dt), self.b1.to(dt))
        s = self._branches(spatial.to(dt), self.w2.to(dt), self.b2.to(dt))
        h = F.relu(a * s)
        # The branch sum commutes with the per-branch output projections; the
        # 16 biases collapse into one.
        out = h.flatten(-2) @ self.w3.to(dt).flatten(0, 1) + self.b3.sum(dim=0).to(dt)
        return F.relu(out) if self.final_relu else out
