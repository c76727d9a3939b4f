"""The full Spatially-Conditioned Graph HOI network.

Mirrors ``skghoi_tpu.models.scg.SpatiallyConditionedGraph``: ImageNet
normalisation in the model dtype -> ResNet-50 + FPN -> detection filtering
(threshold / NMS / caps) -> interaction head.  The forward takes an
:class:`~skghoi_torch.data.structures.HOIBatch` of tensors on the model's
device and returns fixed-shape outputs (scores ``[B, 15, 30, 117]``); with
``training=True`` and targets in the batch, also the three losses.  As in
JAX, ``training`` is an argument of the call, not ``module.training``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from skghoi_torch import constants as C
from skghoi_torch.data.structures import HOIBatch
from skghoi_torch.device import resolve_device
from skghoi_torch.models.backbone import DetectorBackbone
from skghoi_torch.models.interaction_head import (
    InteractionHead,
    InteractionOutputs,
    filter_detections,
)

Tensor = torch.Tensor


class SpatiallyConditionedGraph(nn.Module):
    """Built on ``device`` (default ``cuda``; the CPU only when asked for).

    Parameters are float32; activations and products run in ``dtype``.
    ``frozen_stages=1`` (the stem and ``layer1`` frozen) is the reference's
    mmdet backbone setting.
    """

    def __init__(self, num_classes: int = C.HICO_NUM_VERBS, human_idx: int = C.HICO_HUMAN_IDX,
                 num_object: int = C.HICO_NUM_OBJECTS,
                 box_score_thresh: float = C.BOX_SCORE_THRESH,
                 box_nms_thresh: float = C.BOX_NMS_THRESH, max_human: int = C.MAX_HUMAN,
                 max_object: int = C.MAX_OBJECT, num_iterations: int = C.NUM_MP_ITERATIONS,
                 feedback: bool = False, quirk_box_index_tails: bool = False,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[Union[str, torch.device]] = None, frozen_stages: int = 1,
                 remat_stages: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.human_idx = human_idx
        self.box_score_thresh = box_score_thresh
        self.box_nms_thresh = box_nms_thresh
        self.max_human = max_human
        self.max_object = max_object
        self.compute_dtype = dtype
        self.detector = DetectorBackbone(dtype=dtype, device=device, frozen_stages=frozen_stages,
                                         remat_stages=remat_stages)
        self.interaction_head = InteractionHead(
            num_cls=num_classes, human_idx=human_idx, num_object=num_object,
            num_iter=num_iterations, max_humans=max_human, feedback=feedback,
            quirk_box_index_tails=quirk_box_index_tails, dtype=dtype,
        ).to(device)

    def forward(self, batch: HOIBatch, object_verb_mask: Tensor, *, training: bool = False,
                generator: Optional[torch.Generator] = None,
                gumbel: Optional[Tensor] = None) -> InteractionOutputs:
        """``generator`` or ``gumbel`` (``[B, 15*30*117]``) supply the TransH
        negative-sampling noise in training."""
        dt = self.compute_dtype
        mean = torch.tensor(C.IMAGE_MEAN, dtype=dt, device=batch.images.device)
        std = torch.tensor(C.IMAGE_STD, dtype=dt, device=batch.images.device)
        images = (batch.images.to(dt) - mean) / std

        features = self.detector(images)
        detections = filter_detections(
            batch.det_boxes, batch.det_labels, batch.det_scores, batch.det_valid,
            human_idx=self.human_idx, box_score_thresh=self.box_score_thresh,
            box_nms_thresh=self.box_nms_thresh, max_human=self.max_human,
            max_object=self.max_object,
            # GT boxes join the candidate pool only in training (ref :104-116).
            targets=batch.targets if training else None,
        )
        return self.interaction_head(features, detections, batch.image_sizes, object_verb_mask,
                                     batch.targets, training=training, generator=generator,
                                     gumbel=gumbel)

    @staticmethod
    def total_loss(outputs: InteractionOutputs) -> Tensor:
        """Sum of the three losses (engine semantics, ``utils.py:221``)."""
        if outputs.losses is None:
            raise ValueError("no losses: call the model with training=True and targets")
        return sum(outputs.losses.values())
