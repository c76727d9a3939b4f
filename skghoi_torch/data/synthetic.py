"""Synthetic HICO-DET-format dataset generator for tests and smoke training.

Writes a directory with the exact on-disk contract the real pipeline
consumes: ``instances_{partition}.json`` (reference schema,
``hicodet/hicodet.py:270-293``), JPEG images, and per-image cached detection
JSONs (``{boxes, labels, scores}``,
``hicodet/detections/preprocessing.py:53-75``).  Boxes are placed so that the
cached detections overlap the GT pairs, giving the training loss real positive
samples.  Mirrors ``skghoi_tpu.data.synthetic``: the same numpy seed stream
and the same PIL encoder, so the same files come out byte for byte.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

from skghoi_torch import constants as C


def make_synthetic_hicodet(
    root: str,
    partition: str = "train2015",
    num_images: int = 8,
    image_size: Tuple[int, int] = (120, 160),  # (h, w)
    num_classes: int = C.HICO_NUM_INTERACTIONS,
    seed: int = 0,
) -> str:
    """Create the dataset under ``root``; returns ``root``.

    Uses the real 600-class correspondence structure if available in the
    annotations; otherwise fabricates a consistent (hoi, object, verb) table.
    """
    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = image_size
    img_dir = os.path.join(root, "hico_20160224_det/images", partition)
    det_dir = os.path.join(root, f"detections_{partition}")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(det_dir, exist_ok=True)

    # Fabricated correspondence with unique (object, verb) pairs, like the
    # real 600-class table: enumerate the 80x117 grid in a scrambled order.
    all_pairs = [(o, v) for o in range(C.HICO_NUM_OBJECTS) for v in range(C.HICO_NUM_VERBS)]
    rng.shuffle(all_pairs)
    corr = [[hid, int(o), int(v)] for hid, (o, v) in enumerate(all_pairs[:num_classes])]

    by_obj = {}
    for hid, obj, verb in corr:
        by_obj.setdefault(obj, []).append((hid, verb))

    filenames, sizes, annos = [], [], []
    for i in range(num_images):
        name = f"HICO_{partition}_{i:08d}.jpg"
        filenames.append(name)
        sizes.append([w, h])
        arr = rng.integers(0, 255, (h, w, 3), np.uint8)
        Image.fromarray(arr).save(os.path.join(img_dir, name))

        # One or two GT pairs per image.
        n_pairs = int(rng.integers(1, 3))
        bh, bo, hois, verbs, objs = [], [], [], [], []
        det_boxes, det_labels, det_scores = [], [], []
        for _ in range(n_pairs):
            def rand_box():
                x1 = float(rng.uniform(1, w * 0.5))
                y1 = float(rng.uniform(1, h * 0.5))
                return [x1, y1, x1 + float(rng.uniform(20, w * 0.45)), y1 + float(rng.uniform(20, h * 0.45))]

            hbox, obox = rand_box(), rand_box()
            obj = int(rng.choice(list(by_obj.keys())))
            hid, verb = by_obj[obj][int(rng.integers(len(by_obj[obj])))]
            bh.append(hbox)
            bo.append(obox)
            hois.append(hid)
            verbs.append(verb)
            objs.append(obj)
            # Cached detections: jittered copies of GT + noise boxes.
            for box, label in ((hbox, C.HICO_HUMAN_IDX), (obox, obj)):
                jit = np.asarray(box) + rng.normal(0, 1.5, 4)
                det_boxes.append([float(v) for v in jit])
                det_labels.append(int(label))
                det_scores.append(float(rng.uniform(0.5, 0.99)))
        for _ in range(3):  # distractors
            x1, y1 = float(rng.uniform(0, w - 30)), float(rng.uniform(0, h - 30))
            det_boxes.append([x1, y1, x1 + 25.0, y1 + 25.0])
            det_labels.append(int(rng.integers(C.HICO_NUM_OBJECTS)))
            det_scores.append(float(rng.uniform(0.05, 0.9)))

        annos.append(
            dict(boxes_h=bh, boxes_o=bo, hoi=hois, verb=verbs, object=objs)
        )
        with open(os.path.join(det_dir, name.replace(".jpg", ".json")), "w") as f:
            json.dump(dict(boxes=det_boxes, labels=det_labels, scores=det_scores), f)

    payload = dict(
        filenames=filenames,
        size=sizes,
        empty=[],
        annotation=annos,
        correspondence=corr,
        objects=[f"object_{i}" for i in range(C.HICO_NUM_OBJECTS)],
        verbs=[f"verb_{i}" for i in range(C.HICO_NUM_VERBS)],
    )
    with open(os.path.join(root, f"instances_{partition}.json"), "w") as f:
        json.dump(payload, f)
    return root


def make_synthetic_vcoco(
    root: str,
    partition: str = "test",
    num_images: int = 6,
    image_size: Tuple[int, int] = (120, 160),
    seed: int = 0,
) -> str:
    """Synthetic V-COCO-format dataset: images under ``mscoco2014/``, the
    ``instances_vcoco_{partition}.json`` annotation file (boxes_h/boxes_o/
    actions/objects + image_ids + action names with roles), and cached
    detection JSONs."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = image_size
    img_sub = "mscoco2014/val2014" if partition == "test" else "mscoco2014/train2014"
    img_dir = os.path.join(root, img_sub)
    det_dir = os.path.join(root, f"detections_{partition}")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(det_dir, exist_ok=True)

    actions = [f"act{i} obj" for i in range(C.VCOCO_NUM_ACTIONS)]
    object_to_action = [
        sorted(set(int(x) for x in rng.integers(0, C.VCOCO_NUM_ACTIONS, 6)))
        for _ in range(C.HICO_NUM_OBJECTS)
    ]

    filenames, sizes, annos, image_ids = [], [], [], []
    for i in range(num_images):
        name = f"COCO_{partition}2014_{i:012d}.jpg"
        filenames.append(name)
        sizes.append([w, h])
        image_ids.append(1000 + i)
        Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(
            os.path.join(img_dir, name)
        )

        n_pairs = int(rng.integers(1, 3))
        bh, bo, acts, objs = [], [], [], []
        det_boxes, det_labels, det_scores = [], [], []
        for _ in range(n_pairs):
            def rand_box():
                x1 = float(rng.uniform(1, w * 0.5))
                y1 = float(rng.uniform(1, h * 0.5))
                return [x1, y1, x1 + float(rng.uniform(20, w * 0.45)),
                        y1 + float(rng.uniform(20, h * 0.45))]

            hbox, obox = rand_box(), rand_box()
            objs_with_acts = [o for o, a in enumerate(object_to_action) if a]
            obj = int(rng.choice(objs_with_acts))
            act = int(rng.choice(object_to_action[obj]))
            bh.append(hbox)
            bo.append(obox)
            acts.append(act)
            objs.append(obj)
            for box, label in ((hbox, C.VCOCO_HUMAN_IDX), (obox, obj)):
                jit = np.asarray(box) + rng.normal(0, 1.5, 4)
                det_boxes.append([float(v) for v in jit])
                det_labels.append(int(label))
                det_scores.append(float(rng.uniform(0.5, 0.99)))
        annos.append(dict(boxes_h=bh, boxes_o=bo, actions=acts, objects=objs))
        with open(os.path.join(det_dir, name.replace(".jpg", ".json")), "w") as f:
            json.dump(dict(boxes=det_boxes, labels=det_labels, scores=det_scores), f)

    payload = dict(
        filenames=filenames,
        size=sizes,
        empty=[],
        annotation=annos,
        object_to_action=object_to_action,
        actions=actions,
        image_ids=image_ids,
    )
    with open(os.path.join(root, f"instances_vcoco_{partition}.json"), "w") as f:
        json.dump(payload, f)
    return root
