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

:func:`to_state_dict` maps the variable tree of the JAX package's
``skghoi_tpu.detect.frcnn.FasterRCNN`` the same way, onto
:class:`skghoi_torch.detect.frcnn.FasterRCNN`, whose module names line up
(``body``, ``fpn.lateral.{i}`` / ``fpn.output.{i}``,
``rpn_head.{conv,cls_logits,bbox_pred}``, ``box_head.{fc6,fc7}``,
``box_predictor.{cls_score,bbox_pred}``).  Both detectors flatten their
pooled features in torchvision's channel-major order, so ``fc6`` needs no
permutation.  It maps ``skghoi_tpu.detect.detector.FPNDetector``'s tree onto
:class:`skghoi_torch.detect.detector.FPNDetector` too (``backbone``,
``cls{i}``, ``box{i}``, ``cls_out``, ``box_out``).  The AdaMixer and DETR
trees have shapes the walk does not take: :func:`adamixer_state_dict` and
:func:`detr_state_dict` convert those.

Torch-format checkpoints (no JAX in between):

- :func:`load_torch_resnet50`: a torchvision-named ResNet-50 under a prefix
  (``""``, ``backbone.body.``, ``backbone.``, ``detector_backbone.``) -> the
  port's :class:`~skghoi_torch.models.resnet.ResNet50` ``state_dict``
  (``skghoi_tpu.models.backbone.load_torch_resnet50``);
- :func:`from_reference_state_dict`: the reference checkpoint's
  ``model_state_dict`` (the key families of
  ``skghoi_tpu.oracle.convert.to_flax_variables``) -> the port SCG's
  ``state_dict``.

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

from skghoi_torch import constants as C
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
    """Flax ``{"params", "batch_stats"}`` of the SCG network, the Faster
    R-CNN or the FPN detector -> the port's ``state_dict`` (float32 CPU
    tensors)."""
    params = unroll_resnet_layout(variables["params"])
    stats = unroll_resnet_layout(variables.get("batch_stats", {}))
    sd: Dict[str, np.ndarray] = {}
    _walk("", params, stats, sd)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def cpu_float32(t) -> Tensor:
    """A checkpoint value (tensor or array) as a float32 CPU tensor of its own."""
    return torch.as_tensor(t).detach().to(device="cpu", dtype=torch.float32).clone()


_RESNET_KEY = re.compile(r"(conv1|bn1|layer[1-4])\.")


def load_torch_resnet50(state_dict: Mapping[str, Any], prefix: str = "") -> Dict[str, Tensor]:
    """The torchvision-named ResNet-50 under ``prefix`` in ``state_dict`` ->
    the port ``ResNet50``'s ``state_dict`` (float32 CPU tensors).

    Only the stem's and the four stages' keys are taken (not the ``fc``
    classifier, BN's ``num_batches_tracked`` counters or anything outside
    the prefix); nothing is renamed, since the port's ResNet uses
    torchvision's names."""
    out = {}
    for k, v in state_dict.items():
        name = k[len(prefix):]
        if (k.startswith(prefix) and _RESNET_KEY.match(name)
                and not name.endswith("num_batches_tracked")):
            out[name] = cpu_float32(v)
    if "conv1.weight" not in out:
        raise KeyError(f"no ResNet-50 under prefix {prefix!r} (no {prefix}conv1.weight)")
    return out


def _mbf_from_torch(sd: Mapping[str, Any], name: str) -> Dict[str, Tensor]:
    """The reference's ``{name}.fc_{1,2,3}.{k}`` Linear branches, stacked
    into the port's ``w1..b3`` (``[branch, in, out]`` weights)."""
    out = {}
    for i in (1, 2, 3):
        out[f"w{i}"] = torch.stack([cpu_float32(sd[f"{name}.fc_{i}.{k}.weight"]).T
                                    for k in range(C.MBF_CARDINALITY)])
        out[f"b{i}"] = torch.stack([cpu_float32(sd[f"{name}.fc_{i}.{k}.bias"])
                                    for k in range(C.MBF_CARDINALITY)])
    return out


# port graph-head Linear -> reference module (skghoi_tpu/oracle/convert.py:84-99)
_REFERENCE_LINEARS = {
    "box_head_fc2": "box_head.3", "adjacency": "adjacency", "norm_h": "norm_h",
    "norm_o": "norm_o", "spatial_fc1": "spatial_head.0", "spatial_fc2": "spatial_head.2",
    "spatial_fc3": "spatial_head.4", "fc_head": "fc_head.0", "fc_tail": "fc_tail.0",
}


def from_reference_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, Tensor]:
    """The reference checkpoint's ``model_state_dict`` (also what
    ``skghoi_tpu.oracle.twin.SpatiallyConditionedGraphTwin`` saves) -> the
    port SCG's ``state_dict`` (float32 CPU tensors).

    - ``detector_backbone.*``: torchvision ResNet-50 names;
    - the mmdet neck ``detector_neck.{lateral,fpn}_convs.{i}.conv``;
    - ``interaction_head.box_pair_head.*``: ``box_head.1``, whose input is
      the channel-major flatten of ``[C, 7, 7]`` pooled features, permuted to
      the port's ``(7, 7, C)`` order; the MBF branches ``fc_{1,2,3}.{k}``
      stacked; the other Linears and LayerNorms by name;
    - ``box_pair_head.transh.*`` when present (a real reference checkpoint
      has no TransH tables: load the result with ``strict=False`` and the
      model keeps its own);
    - the pair predictor and suppressor.
    """
    sd = state_dict
    out = {f"detector.backbone.{k}": v
           for k, v in load_torch_resnet50(sd, prefix="detector_backbone.").items()}
    for i in range(4):
        for port, ref in (("lateral", "lateral_convs"), ("output", "fpn_convs")):
            for t in ("weight", "bias"):
                out[f"detector.neck.{port}.{i}.{t}"] = cpu_float32(
                    sd[f"detector_neck.{ref}.{i}.conv.{t}"])

    gh = "interaction_head.box_pair_head"  # the same module path in both
    w = cpu_float32(sd[f"{gh}.box_head.1.weight"])
    c, p = C.FPN_CHANNELS, C.ROI_POOL_SIZE
    out[f"{gh}.box_head_fc1.weight"] = w.reshape(-1, c, p, p).permute(0, 2, 3, 1).reshape(
        w.shape[0], -1).contiguous()
    out[f"{gh}.box_head_fc1.bias"] = cpu_float32(sd[f"{gh}.box_head.1.bias"])
    for port, name in _REFERENCE_LINEARS.items():
        for t in ("weight", "bias"):
            out[f"{gh}.{port}.{t}"] = cpu_float32(sd[f"{gh}.{name}.{t}"])
    for name in ("sub_to_obj", "obj_to_sub", "attention_head", "attention_head_g"):
        for k, v in _mbf_from_torch(sd, f"{gh}.{name}").items():
            out[f"{gh}.{name}.{k}"] = v
    for table in ("ent_embeddings", "rel_embeddings", "norm_vector"):
        key = f"{gh}.transh.{table}.weight"
        if key in sd:
            out[f"{gh}.transh.{table}.weight"] = cpu_float32(sd[key])
    for name in ("box_pair_predictor", "box_pair_suppressor"):
        for t in ("weight", "bias"):
            key = f"interaction_head.{name}.{t}"
            out[key] = cpu_float32(sd[key])
    return out


def kge_state_dict(params: Mapping) -> Dict[str, Tensor]:
    """JAX KGE parameter tree (or a gradient tree of it) -> the port KGE
    model's ``state_dict`` (float32 CPU tensors)."""
    return {f"{name}.weight": torch.from_numpy(np.array(t["embedding"], dtype=np.float32))
            for name, t in params["params"].items()}


# --- the JAX stage-1 detectors -------------------------------------------------
#
# ``_walk`` takes a module whose values are not all submodules for a leaf, and
# ``_leaf_module`` transposes 2-D kernels: three shapes of the detector trees
# need their own rules, so they are taken out of the tree before the walk and
# converted here.

def _to_tensors(sd: Mapping[str, Any]) -> Dict[str, Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def _flax_attention(p: Mapping) -> Dict[str, np.ndarray]:
    """flax ``MultiHeadDotProductAttention``: ``query/key/value`` kernels
    ``[D, H, D/H]`` with ``[H, D/H]`` biases, ``out`` kernel ``[H, D/H, D]``
    -> ``Linear(D, D)`` weights ``[out, in]``."""
    out = {}
    for name in ("query", "key", "value"):
        k = np.asarray(p[name]["kernel"])
        out[f"{name}.weight"] = k.reshape(k.shape[0], -1).T
        out[f"{name}.bias"] = np.asarray(p[name]["bias"]).reshape(-1)
    k = np.asarray(p["out"]["kernel"])
    out["out.weight"] = k.reshape(-1, k.shape[-1]).T
    out["out.bias"] = np.asarray(p["out"]["bias"])
    return out


def _packed_attention(p: Mapping) -> Dict[str, np.ndarray]:
    """``skghoi_tpu.detect.detr.PackedMHA``: torch's layout already (its
    ``out_proj_kernel`` is ``[out, in]``)."""
    return {"in_proj_weight": np.asarray(p["in_proj_weight"]),
            "in_proj_bias": np.asarray(p["in_proj_bias"]),
            "out_proj.weight": np.asarray(p["out_proj_kernel"]),
            "out_proj.bias": np.asarray(p["out_proj_bias"])}


def adamixer_state_dict(variables: Mapping) -> Dict[str, Tensor]:
    """Flax variables of ``skghoi_tpu.detect.adamixer.AdaMixerDetector`` ->
    the port's :class:`~skghoi_torch.detect.adamixer.AdaMixerDetector`
    ``state_dict``.  Taken out of the walk: the decoder's raw
    ``init_content_features`` (an array beside the ``stage{s}`` modules) and
    each stage's ``self_attn`` (3-D ``DenseGeneral`` kernels, reshaped)."""
    params = dict(variables["params"])
    decoder = dict(params["decoder"])
    extra = {"decoder.init_content_features": np.asarray(decoder.pop("init_content_features"))}
    for name in [n for n in decoder if n.startswith("stage")]:
        stage = dict(decoder[name])
        for k, v in _flax_attention(stage.pop("self_attn")).items():
            extra[f"decoder.{name}.self_attn.{k}"] = v
        decoder[name] = stage
    params["decoder"] = decoder
    sd = to_state_dict({"params": params, "batch_stats": variables.get("batch_stats", {})})
    return {**sd, **_to_tensors(extra)}


_DETR_LISTS = ((re.compile(r"enc(\d+)\."), r"encoder.\1."), (re.compile(r"dec(\d+)\."), r"decoder.\1."),
               (re.compile(r"bbox(\d+)\."), r"bbox_mlp.\1."))


def detr_state_dict(variables: Mapping) -> Dict[str, Tensor]:
    """Flax variables of ``skghoi_tpu.detect.detr.DETR`` -> the port's
    :class:`~skghoi_torch.detect.detr.DETR` ``state_dict``: ``enc{i}`` /
    ``dec{i}`` / ``bbox{i}`` become ``encoder.{i}`` / ``decoder.{i}`` /
    ``bbox_mlp.{i}``.  Taken out of the walk: the raw ``query_embed`` (an
    array beside the layers) and every ``PackedMHA``, whose parameters the
    walk would copy under their flax names."""
    params = dict(variables["params"])
    extra = {"query_embed": np.asarray(params.pop("query_embed"))}
    for name in [n for n in params if re.fullmatch(r"(enc|dec)\d+", n)]:
        layer = dict(params[name])
        for attn in ("self_attn", "multihead_attn"):
            if attn in layer:
                for k, v in _packed_attention(layer.pop(attn)).items():
                    extra[f"{name}.{attn}.{k}"] = v
        params[name] = layer
    sd = {**to_state_dict({"params": params, "batch_stats": variables.get("batch_stats", {})}),
          **_to_tensors(extra)}
    out = {}
    for k, v in sd.items():
        for pat, rep in _DETR_LISTS:
            k = pat.sub(rep, k, count=1) if pat.match(k) else k
        out[k] = v
    return out


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

