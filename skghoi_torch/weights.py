"""Parameters of the port: seeded initialisation, and import of the JAX
package's ``{"params", "batch_stats"}`` trees.

:func:`to_state_dict` maps a flax variable tree of
``skghoi_tpu.models.SpatiallyConditionedGraph`` (numpy arrays, as
``model.init`` gives them) onto the port's ``state_dict``:

- conv kernels HWIO -> OIHW; dense kernels transposed into Linear weights;
  ``box_head_fc1`` keeps its ``(7, 7, C)`` input order, since the port's
  pooled features are NHWC too;
- MBF ``w1..b3`` as they are; LayerNorm ``scale`` -> ``weight``; frozen BN
  ``scale/bias/mean/var`` -> ``weight/bias/running_mean/running_var``;
  TransH embedding tables;
- ResNet blocks in either JAX layout: unrolled ``layer{s}_block{b}`` or
  scanned ``layer{s}_rest`` (tail blocks stacked on axis 0).

A gradient tree (``jax.grad`` over ``params``: the same structure) maps the
same way, as ``to_state_dict({"params": grads})``: each gradient lands under
the name of the port parameter it belongs to (frozen-BN terms land on the
port's buffers, which take no gradient).

:func:`kge_state_dict` maps the parameter tree of a ``skghoi_tpu.kge`` model
(``{"params": {table: {"embedding": ...}}}``, as ``model.init`` or a decoded
KGE checkpoint gives it) onto the ``state_dict`` of the port's model of the
same name: each table keeps its OpenKE name.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from skghoi_torch.kge.models import TransH
from skghoi_torch.models.mbf import MultiBranchFusion

Tensor = torch.Tensor

# flax module name -> port module path, for the names that differ.
_RENAMES = (
    (r"stem_conv", "conv1"),
    (r"stem_bn", "bn1"),
    (r"(layer\d+)_block(\d+)", r"\1.\2"),
    (r"downsample_conv", "downsample.0"),
    (r"downsample_bn", "downsample.1"),
    (r"(lateral|output)(\d+)", r"\1.\2"),
)


def _rename(name: str) -> str:
    for pat, rep in _RENAMES:
        if re.fullmatch(pat, name):
            return re.sub(pat, rep, name)
    return name


def _tree_index(tree, i: int):
    if isinstance(tree, Mapping):
        return {k: _tree_index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def unroll_resnet_layout(tree: Mapping) -> Dict[str, Any]:
    """Scanned ``layer{s}_rest`` subtrees (stacked on axis 0) -> unrolled
    ``layer{s}_block{1..}``, at any depth; other keys pass through."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        v = unroll_resnet_layout(v) if isinstance(v, Mapping) else v
        m = re.fullmatch(r"(layer\d+)_rest", k)
        if m is None:
            out[k] = v
            continue
        first_leaf = v
        while isinstance(first_leaf, Mapping):
            first_leaf = next(iter(first_leaf.values()))
        for i in range(np.asarray(first_leaf).shape[0]):
            out[f"{m.group(1)}_block{i + 1}"] = _tree_index(v, i)
    return out


def _leaf_module(prefix: str, p: Mapping, s: Optional[Mapping], sd: Dict[str, np.ndarray]):
    if "kernel" in p:
        k = np.asarray(p["kernel"])
        sd[prefix + "weight"] = k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T
        if "bias" in p:
            sd[prefix + "bias"] = np.asarray(p["bias"])
    elif "scale" in p:  # LayerNorm, or frozen BN with its statistics
        sd[prefix + "weight"] = np.asarray(p["scale"])
        sd[prefix + "bias"] = np.asarray(p["bias"])
        if s is not None:
            sd[prefix + "running_mean"] = np.asarray(s["mean"])
            sd[prefix + "running_var"] = np.asarray(s["var"])
    elif "embedding" in p:
        sd[prefix + "weight"] = np.asarray(p["embedding"])
    else:  # MBF stacked branch weights
        for name, v in p.items():
            sd[prefix + name] = np.asarray(v)


def _walk(prefix: str, p: Mapping, s: Optional[Mapping], sd: Dict[str, np.ndarray]):
    if any(not isinstance(v, Mapping) for v in p.values()):
        _leaf_module(prefix, p, s, sd)
        return
    for name, sub in p.items():
        _walk(f"{prefix}{_rename(name)}.", sub, None if s is None else s.get(name), sd)


def to_state_dict(variables: Mapping) -> Dict[str, Tensor]:
    """Flax ``{"params", "batch_stats"}`` of the SCG network -> the port's
    ``state_dict`` (float32 CPU tensors)."""
    params = unroll_resnet_layout(variables["params"])
    stats = unroll_resnet_layout(variables.get("batch_stats", {}))
    sd: Dict[str, np.ndarray] = {}
    _walk("", params, stats, sd)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def kge_state_dict(params: Mapping) -> Dict[str, Tensor]:
    """JAX KGE parameter tree (or a gradient tree of it) -> the port KGE
    model's ``state_dict`` (float32 CPU tensors)."""
    return {f"{name}.weight": torch.from_numpy(np.array(t["embedding"], dtype=np.float32))
            for name, t in params["params"].items()}


@torch.no_grad()
def init_parameters(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights: LeCun-normal conv/dense kernels (the flax
    default) with zero biases, torch-default MBF branches, Xavier TransH
    tables; LayerNorm and frozen BN at identity."""
    g = torch.Generator().manual_seed(seed)
    for module in model.modules():
        if isinstance(module, (nn.Conv2d, nn.Linear)):
            fan_in = math.prod(module.weight.shape[1:])
            module.weight.normal_(0.0, fan_in ** -0.5, generator=g)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, (MultiBranchFusion, TransH)):
            module.reset_parameters(generator=g)
        elif isinstance(module, nn.LayerNorm):
            module.reset_parameters()
    return model

