"""The one traffic generator: a pool of collated numpy batches from a traffic
file's parameters and the run's seed.

A traffic file (``hoibench/traffic/<name>.json``) gives:

- ``batch``: images a batch; ``pool``: batches in the pool, cycled;
- ``canvases``: ``[[H, W], ...]`` and ``canvas_share``: how many of every
  ``sum(canvas_share)`` batches take each, as exact counts over the pool (the
  seed orders them, so every seed runs the same set of shapes);
- ``image``: the resized image inside its canvas, ``short`` side and
  ``long`` range (the HICO-DET transform: short side 800, long at most 1333),
  and ``normalise``: whether the pixels are ImageNet-normalised (a detector's
  input) or left in [0, 1] (the SCG normalises itself);
- ``detections`` (optional): ``valid`` range a image, ``pad`` (slots a
  image), ``humans`` (the least number of human boxes), ``score`` range,
  ``tall_share`` (standing persons, aspect 4-6);
- ``pairs`` (optional): ground-truth pairs, ``valid`` range and ``pad``.

Every seed runs the same work in another order: the canvases, the images'
long sides and the numbers of detections and pairs are each one fixed set,
spread evenly over its range across the pool's images, which the seed
permutes.  Box geometry is ``entry.make_batch``'s: corner uniform in the
first 40% of the short side, log-uniform scale 16 px .. 35% of the short
side, aspect in [1/3, 3] but the tall share, clipped to the image.  Pixels
are uniform noise inside the image and zero in the canvas padding, drawn on
``device`` and brought to the host; everything else is drawn by numpy.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from hoibench.weights import sub_seed

HUMAN = 49
N_OBJECTS = 80
N_VERBS = 117
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def canvas_order(traffic: dict, rng: np.random.Generator) -> List[tuple]:
    canvases, share = traffic["canvases"], traffic.get("canvas_share", [1] * len(traffic["canvases"]))
    pool = traffic["pool"]
    counts = [int(round(pool * s / sum(share))) for s in share]
    counts[0] += pool - sum(counts)
    order = [tuple(c) for c, n in zip(canvases, counts) for _ in range(n)]
    return [order[i] for i in rng.permutation(pool)]


def _boxes(rng, n, h, w, tall_share):
    short = min(h, w)
    xy = rng.uniform(0, short * 0.4, (n, 2))
    scale = np.exp(rng.uniform(np.log(16), np.log(short * 0.35), n))
    log_a = rng.uniform(np.log(1 / 3), np.log(3.0), n)
    tall = rng.uniform(size=n) < tall_share
    log_a = np.where(tall, np.log(rng.uniform(4.0, 6.0, n)), log_a)
    wh = np.stack([scale / np.exp(log_a / 2), scale * np.exp(log_a / 2)], -1)
    return np.concatenate([xy, np.minimum(xy + wh, [w - 1, h - 1])], -1).astype(np.float32)


def spread(lo: int, hi: int, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` whole numbers spread evenly over ``[lo, hi]``, in the seed's order."""
    return rng.permutation(np.rint(np.linspace(lo, hi, n)).astype(np.int64))


def make_batch(traffic: dict, canvas, counts: Dict[str, np.ndarray], rng: np.random.Generator,
               pixels: torch.Generator, device) -> Dict[str, np.ndarray]:
    """One collated batch on one canvas, as the loader's ``collate`` pads it;
    ``counts`` gives each image's long side, detections and pairs."""
    b, (ch, cw) = traffic["batch"], canvas
    img = traffic["image"]
    long_side = counts["long"]
    hw = np.where(ch <= cw, np.stack([np.full(b, img["short"]), long_side], -1),
                  np.stack([long_side, np.full(b, img["short"])], -1)).astype(np.int64)
    hw = np.minimum(hw, [ch, cw])
    images = torch.rand((b, ch, cw, 3), generator=pixels, device=device)
    inside = ((torch.arange(ch, device=device)[None, :, None] < torch.as_tensor(hw[:, 0], device=device)[:, None, None])
              & (torch.arange(cw, device=device)[None, None, :] < torch.as_tensor(hw[:, 1], device=device)[:, None, None]))
    images = images * inside[..., None]
    if img.get("normalise", False):
        images = (images - torch.tensor(MEAN, device=device)) / torch.tensor(STD, device=device)
    out = dict(images=images.cpu().numpy(), image_sizes=hw.astype(np.float32),
               original_sizes=np.round(hw * 0.6).astype(np.float32))
    det = traffic.get("detections")
    if det:
        m = det["pad"]
        boxes = np.zeros((b, m, 4), np.float32)
        labels = np.zeros((b, m), np.int32)
        scores = np.zeros((b, m), np.float32)
        valid = np.zeros((b, m), bool)
        for i in range(b):
            n = int(counts["detections"][i])
            boxes[i, :n] = _boxes(rng, n, hw[i, 0], hw[i, 1], det["tall_share"])
            lab = rng.integers(0, N_OBJECTS, n)
            lab[:det["humans"]] = HUMAN
            labels[i, :n] = lab
            scores[i, :n] = rng.uniform(det["score"][0], det["score"][1], n)
            valid[i, :n] = True
        out.update(det_boxes=boxes, det_labels=labels, det_scores=scores, det_valid=valid)
    pairs = traffic.get("pairs")
    if pairs:
        g = pairs["pad"]
        gt = dict(gt_boxes_h=np.zeros((b, g, 4), np.float32), gt_boxes_o=np.zeros((b, g, 4), np.float32),
                  gt_object=np.zeros((b, g), np.int32), gt_labels=np.zeros((b, g), np.int32),
                  gt_valid=np.zeros((b, g), bool))
        for i in range(b):
            n = int(counts["pairs"][i])
            gt["gt_boxes_h"][i, :n] = _boxes(rng, n, hw[i, 0], hw[i, 1], 1.0)
            gt["gt_boxes_o"][i, :n] = _boxes(rng, n, hw[i, 0], hw[i, 1], 0.0)
            gt["gt_object"][i, :n] = rng.integers(0, N_OBJECTS, n)
            gt["gt_labels"][i, :n] = rng.integers(0, N_VERBS, n)
            gt["gt_valid"][i, :n] = True
        out.update(gt)
    return out


def make_pool(traffic: dict, seed: int, device) -> List[Dict[str, np.ndarray]]:
    """``traffic["pool"]`` batches, the same for the same seed."""
    rng = np.random.default_rng(sub_seed(seed, "traffic"))
    pixels = torch.Generator(device=device).manual_seed(sub_seed(seed, "pixels"))
    b, n = traffic["batch"], traffic["batch"] * traffic["pool"]
    ranges = dict(long=traffic["image"]["long"],
                  detections=(traffic.get("detections") or {}).get("valid", (0, 0)),
                  pairs=(traffic.get("pairs") or {}).get("valid", (0, 0)))
    counts = {k: spread(lo, hi, n, rng) for k, (lo, hi) in ranges.items()}
    return [make_batch(traffic, canvas, {k: v[i * b:(i + 1) * b] for k, v in counts.items()},
                       rng, pixels, device)
            for i, canvas in enumerate(canvas_order(traffic, rng))]


def object_verb_mask(interactions: int, seed: int) -> np.ndarray:
    """``[80, 117]`` float mask with ``interactions`` valid (object, verb) pairs,
    at least one verb for every object (HICO-DET has 600)."""
    rng = np.random.default_rng(sub_seed(seed, "verbs"))
    mask = np.zeros((N_OBJECTS, N_VERBS), np.float32)
    mask[np.arange(N_OBJECTS), rng.integers(0, N_VERBS, N_OBJECTS)] = 1.0
    free = np.flatnonzero(mask.ravel() == 0)
    mask.ravel()[rng.choice(free, interactions - N_OBJECTS, replace=False)] = 1.0
    return mask
