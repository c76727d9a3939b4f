"""DataFactory + padded batching: dataset -> device-ready ``HOIBatch``.

Mirrors the reference ``DataFactory`` (``utils.py:44-146``): wraps
HICO-DET/V-COCO, remaps target keys (``verb``->``labels``; HICO GT boxes are
1-based pixel indices, so ``boxes[:, :2] -= 1``), loads the cached per-image
detection JSON (``{boxes, labels, scores}`` contract,
``hicodet/detections/preprocessing.py:53-75``), and applies optional random
horizontal flips.  Where the reference collates ragged lists
(``custom_collate``, ``utils.py:34-42``), :class:`HOILoader` pads everything
to fixed shapes, buckets batches by image orientation (two static canvases,
so the card sees two input shapes), and shards deterministically across
hosts — replacing ``DistributedSampler`` (``configures/.../main.py:50-63``).

Mirrors ``skghoi_tpu.data.factory``: samples and collated batches are the same
numpy arrays.  :func:`to_device` then moves a collated batch to the card
through pinned memory with non-blocking copies (labels become int64).
"""

from __future__ import annotations

import json
import os
from typing import Iterator, List, Sequence

import numpy as np
import torch

from skghoi_torch import constants as C
from skghoi_torch.data.structures import HOIBatch, HOITargets
from skghoi_torch.data.transforms import (
    canvas_for,
    hflip_image_and_boxes,
    prepare_image,
    resize_scale,
    resized_size,
    scale_boxes,
)
from skghoi_torch.device import resolve_device
from skghoi_torch.utils.profiling import span


class DataFactory:
    def __init__(
        self,
        name: str,
        partition: str,
        data_root: str,
        detection_root: str,
        flip: bool = False,
        seed: int = 0,
        min_size: int = C.IMAGE_MIN_SIZE,
        max_size: int = C.IMAGE_MAX_SIZE,
        canvas_landscape=C.CANVAS_LANDSCAPE,
        canvas_portrait=C.CANVAS_PORTRAIT,
        device_resize: bool = False,
        raw_canvas_landscape=(768, 1152),
        raw_canvas_portrait=(1152, 768),
    ):
        self.min_size = min_size
        self.max_size = max_size
        self.canvas_landscape = tuple(canvas_landscape)
        self.canvas_portrait = tuple(canvas_portrait)
        # device_resize: samples carry the decoded uint8 image padded into a
        # static raw canvas instead of a host-resized float canvas; the
        # bilinear resize + mean fill then run on device
        # (``data/device_preprocess.device_resize_canvas``).  uint8 transfer
        # is 4x lighter and the resize leaves the host.
        self.device_resize = device_resize
        self.raw_canvas_landscape = tuple(raw_canvas_landscape)
        self.raw_canvas_portrait = tuple(raw_canvas_portrait)
        if device_resize:
            # The device preprocess picks the *target* canvas from the raw
            # batch's orientation (``device_preprocess.prepare_batch``), so
            # the raw canvases must be strictly oriented — a square/swapped
            # raw canvas would silently route portrait batches onto the
            # landscape target and crop them.
            if not (self.raw_canvas_landscape[0] < self.raw_canvas_landscape[1]
                    and self.raw_canvas_portrait[0] > self.raw_canvas_portrait[1]):
                raise ValueError(
                    "device_resize requires strictly oriented raw canvases: "
                    f"landscape {self.raw_canvas_landscape} must be H<W and "
                    f"portrait {self.raw_canvas_portrait} must be H>W"
                )
        if name not in ("hicodet", "vcoco"):
            raise ValueError(f"Unknown dataset {name}")
        self.name = name
        if name == "hicodet":
            from skghoi_torch.data.hicodet import HICODet

            assert partition in ("train2015", "test2015"), f"Unknown HICO-DET partition {partition}"
            self.dataset = HICODet(
                root=os.path.join(data_root, "hico_20160224_det/images", partition),
                anno_file=os.path.join(data_root, f"instances_{partition}.json"),
            )
            self.human_idx = C.HICO_HUMAN_IDX
        else:
            from skghoi_torch.data.vcoco import VCOCO

            assert partition in ("train", "val", "trainval", "test"), (
                f"Unknown V-COCO partition {partition}"
            )
            image_dir = dict(
                train="mscoco2014/train2014",
                val="mscoco2014/train2014",
                trainval="mscoco2014/train2014",
                test="mscoco2014/val2014",
            )
            self.dataset = VCOCO(
                root=os.path.join(data_root, image_dir[partition]),
                anno_file=os.path.join(data_root, f"instances_vcoco_{partition}.json"),
            )
            self.human_idx = C.VCOCO_HUMAN_IDX

        if device_resize:
            # Fail at construction, not mid-epoch: a single oversize image
            # would otherwise raise in __getitem__ hours into a run.  The
            # annotation's size metadata makes this a metadata scan — no
            # decoding (ADVICE r4: the default raw canvas is an unverified
            # bound for real HICO-DET/V-COCO images).
            for i in range(len(self.dataset)):
                w, h = self.dataset.image_size(i)
                rc = canvas_for(h, w, self.raw_canvas_landscape, self.raw_canvas_portrait)
                if h > rc[0] or w > rc[1]:
                    raise ValueError(
                        f"device_resize: image {i} ({h}x{w}) exceeds raw canvas "
                        f"{rc}; raise raw_canvas_landscape/portrait to cover the "
                        "dataset's max dimensions"
                    )

        self.detection_root = detection_root
        rng = np.random.default_rng(seed)
        self._flip = rng.integers(0, 2, len(self.dataset)).astype(bool) if flip else np.zeros(
            len(self.dataset), bool
        )

    def __len__(self) -> int:
        return len(self.dataset)

    def _load_detection(self, i: int) -> dict:
        path = os.path.join(
            self.detection_root, self.dataset.filename(i).replace(".jpg", ".json")
        )
        with open(path, "r") as f:
            det = json.load(f)
        return {
            "boxes": np.asarray(det["boxes"], np.float32).reshape(-1, 4),
            "labels": np.asarray(det["labels"], np.int32).reshape(-1),
            "scores": np.asarray(det["scores"], np.float32).reshape(-1),
        }

    def __getitem__(self, i: int) -> dict:
        image, target = self.dataset[i]
        if self.name == "hicodet":
            target["labels"] = target["verb"]
            boxes_h = np.asarray(target["boxes_h"], np.float32).reshape(-1, 4)
            boxes_o = np.asarray(target["boxes_o"], np.float32).reshape(-1, 4)
            # pixel indices -> coordinates (utils.py:124-127)
            boxes_h[:, :2] -= 1
            boxes_o[:, :2] -= 1
        else:
            target["labels"] = target["actions"]
            target["object"] = target.pop("objects")
            boxes_h = np.asarray(target["boxes_h"], np.float32).reshape(-1, 4)
            boxes_o = np.asarray(target["boxes_o"], np.float32).reshape(-1, 4)

        det = self._load_detection(i)
        det_boxes = det["boxes"]

        if self._flip[i]:
            image, (det_boxes, boxes_h, boxes_o) = hflip_image_and_boxes(
                image, det_boxes, boxes_h, boxes_o
            )

        h, w = image.shape[:2]
        canvas = canvas_for(h, w, self.canvas_landscape, self.canvas_portrait)
        if self.device_resize:
            raw_canvas = canvas_for(
                h, w, self.raw_canvas_landscape, self.raw_canvas_portrait
            )
            if h > raw_canvas[0] or w > raw_canvas[1]:
                raise ValueError(
                    f"image {h}x{w} exceeds raw canvas {raw_canvas}; raise "
                    "raw_canvas_landscape/portrait (device_resize mode)"
                )
            scale = resize_scale(h, w, self.min_size, self.max_size)
            nh, nw = resized_size(h, w, scale)
            nh, nw = min(nh, canvas[0]), min(nw, canvas[1])
            arr = np.zeros((*raw_canvas, 3), np.uint8)
            arr[:h, :w] = image
        else:
            arr, (nh, nw), _ = prepare_image(image, canvas, self.min_size, self.max_size)

        return dict(
            image=arr,
            image_size=np.asarray([nh, nw], np.float32),
            original_size=np.asarray([h, w], np.float32),
            canvas=canvas,
            det_boxes=scale_boxes(det_boxes, (h, w), (nh, nw)),
            det_labels=det["labels"],
            det_scores=det["scores"],
            gt_boxes_h=scale_boxes(boxes_h, (h, w), (nh, nw)),
            gt_boxes_o=scale_boxes(boxes_o, (h, w), (nh, nw)),
            gt_object=np.asarray(target["object"], np.int32).reshape(-1),
            gt_labels=np.asarray(target["labels"], np.int32).reshape(-1),
            index=i,
        )


def collate(samples: Sequence[dict], max_dets: int = C.MAX_RAW_DETECTIONS,
            max_gt: int = C.MAX_GT_PAIRS, with_targets: bool = True) -> HOIBatch:
    """Pad a list of factory samples (same canvas!) into one HOIBatch."""
    b = len(samples)
    canvas = samples[0]["canvas"]
    assert all(s["canvas"] == canvas for s in samples), "mixed canvases in one batch"

    images = np.stack([s["image"] for s in samples])
    image_sizes = np.stack([s["image_size"] for s in samples])
    original_sizes = np.stack([s["original_size"] for s in samples])

    det_boxes = np.zeros((b, max_dets, 4), np.float32)
    det_labels = np.zeros((b, max_dets), np.int32)
    det_scores = np.zeros((b, max_dets), np.float32)
    det_valid = np.zeros((b, max_dets), bool)
    for i, s in enumerate(samples):
        m = min(len(s["det_boxes"]), max_dets)
        det_boxes[i, :m] = s["det_boxes"][:m]
        det_labels[i, :m] = s["det_labels"][:m]
        det_scores[i, :m] = s["det_scores"][:m]
        det_valid[i, :m] = True

    targets = None
    if with_targets:
        gt_h = np.zeros((b, max_gt, 4), np.float32)
        gt_o = np.zeros((b, max_gt, 4), np.float32)
        gt_obj = np.zeros((b, max_gt), np.int32)
        gt_lab = np.zeros((b, max_gt), np.int32)
        gt_valid = np.zeros((b, max_gt), bool)
        for i, s in enumerate(samples):
            g = min(len(s["gt_boxes_h"]), max_gt)
            gt_h[i, :g] = s["gt_boxes_h"][:g]
            gt_o[i, :g] = s["gt_boxes_o"][:g]
            gt_obj[i, :g] = s["gt_object"][:g]
            gt_lab[i, :g] = s["gt_labels"][:g]
            gt_valid[i, :g] = True
        targets = HOITargets(gt_h, gt_o, gt_obj, gt_lab, gt_valid)

    return HOIBatch(
        images, image_sizes, original_sizes, det_boxes, det_labels, det_scores, det_valid, targets
    )


class HOILoader:
    """Orientation-bucketed, host-sharded, padded batch iterator.

    Batches contain only same-canvas images, so the forward sees one input
    shape per orientation.  ``num_shards``/``shard_index`` reproduce the
    reference's per-process ``DistributedSampler`` sharding.
    """

    def __init__(
        self,
        factory: DataFactory,
        batch_size: int,
        shuffle: bool = False,
        with_targets: bool = True,
        num_shards: int = 1,
        shard_index: int = 0,
        seed: int = 0,
        drop_last: bool = False,
        num_workers: int = 0,
        prefetch: int = 2,
    ):
        self.factory = factory
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.with_targets = with_targets
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.seed = seed
        self.drop_last = drop_last
        # torch-DataLoader-equivalent async input pipeline (the reference uses
        # num_workers=4, configures/...main.py): sample decode/resize runs on
        # a thread pool (PIL/numpy release the GIL for the heavy parts) and
        # ``prefetch`` whole batches are collated ahead so the device never
        # waits on host IO.  0 = fully synchronous (deterministic debugging).
        self.num_workers = num_workers
        self.prefetch = max(1, prefetch)
        self.epoch = 0

        # Orientation per sample, from dataset metadata (no image decode).
        self._portrait = np.asarray(
            [
                (lambda wh: wh[1] > wh[0])(factory.dataset.image_size(i))
                for i in range(len(factory))
            ]
        )

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _batches(self) -> List[List[int]]:
        rng = np.random.default_rng(self.seed + self.epoch)
        idx = np.arange(len(self.factory))
        if self.shuffle:
            idx = rng.permutation(idx)
        idx = idx[self.shard_index :: self.num_shards]
        batches = []
        for orient in (False, True):
            pool = [int(i) for i in idx if self._portrait[i] == orient]
            for s in range(0, len(pool), self.batch_size):
                chunk = pool[s : s + self.batch_size]
                if self.drop_last and len(chunk) < self.batch_size:
                    continue
                batches.append(chunk)
        if self.shuffle:
            order = rng.permutation(len(batches))
            batches = [batches[i] for i in order]
        return batches

    def __len__(self) -> int:
        return len(self._batches())

    def _make_batch(self, batch_idx: List[int], pool=None) -> HOIBatch:
        if pool is not None:
            samples = list(pool.map(self.factory.__getitem__, batch_idx))
        else:
            samples = [self.factory[i] for i in batch_idx]
        # Pad short batches by repeating the last sample (masked anyway
        # by per-image results downstream via batch bookkeeping).
        while len(samples) < self.batch_size:
            samples.append(samples[-1])
        return collate(samples, with_targets=self.with_targets)

    def __iter__(self) -> Iterator[HOIBatch]:
        batches = self._batches()
        if self.num_workers <= 0:
            for batch_idx in batches:
                yield self._make_batch(batch_idx), batch_idx
            return

        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(self.num_workers) as samples_pool, \
                ThreadPoolExecutor(self.prefetch) as batch_pool:
            pending = []
            for batch_idx in batches[: self.prefetch]:
                pending.append(
                    (batch_pool.submit(self._make_batch, batch_idx, samples_pool), batch_idx)
                )
            cursor = self.prefetch
            while pending:
                fut, batch_idx = pending.pop(0)
                if cursor < len(batches):
                    nxt = batches[cursor]
                    pending.append(
                        (batch_pool.submit(self._make_batch, nxt, samples_pool), nxt)
                    )
                    cursor += 1
                yield fut.result(), batch_idx


def to_device(batch: HOIBatch, device=None) -> HOIBatch:
    """A collated numpy batch as tensors on ``device`` (default ``cuda``).

    On the card every array goes through pinned memory with a non-blocking
    copy, so the host does not wait for the stream to drain; int32 labels
    become int64.  The images keep their dtype (float canvases, or raw uint8
    for :mod:`~skghoi_torch.data.device_preprocess`)."""
    device = resolve_device(device)

    def move(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if t.dtype == torch.int32:
            t = t.long()
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    with span("to_device"):
        targets = None
        if batch.targets is not None:
            targets = HOITargets(*map(move, batch.targets))
        return HOIBatch(*map(move, batch[:-1]), targets)
