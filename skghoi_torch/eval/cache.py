"""Cache inference results in the official evaluator formats.

HICO-DET (reference ``cache.py:28-95``): a ``600 x n_images`` object array of
``[x1h y1h x2h y2h x1o y1o x2o y2o score]`` rows (boxes converted back to
pixel indices: ``boxes[:, 2:] -= 1``), written per COCO object class as
``detections_XX.mat`` with key ``all_boxes`` holding that object's interaction
rows — the exact layout the official HICO-DET MATLAB evaluator consumes.
Empty entries are ``(0, 0)`` float arrays.

V-COCO (reference ``cache.py:97-143``, ``cache_template.py``): one
``CacheTemplate`` dict per (pair, action) with ``image_id``, ``person_box``,
``{action}_agent`` score and ``{action}_{role}`` = role box + score; missing
keys default to score 0 / a tiny box.  Written as ``vcoco_results.pkl``
(pickle protocol 2 for the official python2 evaluator).

Mirrors ``skghoi_tpu.eval.cache``: the same files, the same layout.
"""

from __future__ import annotations

import os
import pickle
from collections import defaultdict
from typing import Dict, List

import numpy as np
from scipy import io as sio

from skghoi_torch.eval.hoi_eval import to_numpy, unpack_image_results


class CacheTemplate(defaultdict):
    """A template for VCOCO cached results."""

    def __init__(self, **kwargs):
        super().__init__()
        for k, v in kwargs.items():
            self[k] = v

    def __missing__(self, k):
        seg = k.split("_")
        if seg[-1] == "agent":
            return 0.0
        return [0.0, 0.0, 0.1, 0.1, 0.0]


def build_coco_to_hico(coco_names: List[str], hico_names: List[str]) -> Dict[str, int]:
    """Name-based COCO-80 -> HICO-80 class-id mapping.

    The reference ships this as a data file (``coco80tohico80.json``,
    ``cache.py:186-188``); when absent it is reconstructed by matching class
    names (HICO uses underscores, COCO spaces).
    """
    norm = lambda s: s.lower().replace(" ", "_")
    hico_lut = {norm(n): i for i, n in enumerate(hico_names)}
    return {str(i): hico_lut[norm(n)] for i, n in enumerate(coco_names) if norm(n) in hico_lut}


def cache_hicodet_mat(
    eval_step,
    params,
    loader,
    dataset,
    coco2hico: Dict[str, int],
    cache_dir: str,
) -> None:
    """Run inference over ``loader`` and write per-object-class .mat files."""
    os.makedirs(cache_dir, exist_ok=True)
    nimages = len(dataset.annotations)  # includes empty images (cache.py:33)
    all_results = np.empty((dataset.num_interaction_cls, nimages), dtype=object)
    o2i = np.asarray(
        [[i if i is not None else -1 for i in row] for row in dataset.object_n_verb_to_interaction]
    )

    for batch, indices in loader:
        out = to_numpy(eval_step(params, batch))
        for slot, ds_index in enumerate(indices):
            res = unpack_image_results(out, batch, slot)
            image_idx = dataset._idx[ds_index]

            bh = res["boxes_h"].copy()
            bo = res["boxes_o"].copy()
            # coordinates -> pixel indices (cache.py:56-57)
            bh[:, 2:] -= 1
            bo[:, 2:] -= 1
            interactions = o2i[res["object"], res["prediction"]]
            keep = interactions >= 0
            rows = np.concatenate(
                [bh[keep], bo[keep], res["scores"][keep, None]], axis=1
            )
            for cls_id in np.unique(interactions[keep]):
                sel = interactions[keep] == cls_id
                all_results[cls_id, image_idx] = rows[sel]

    for i in range(all_results.shape[0]):
        for j in range(nimages):
            if all_results[i, j] is None:
                all_results[i, j] = np.zeros((0, 0))

    object2int = dataset.object_to_interaction
    for object_idx in coco2hico:
        interaction_idx = object2int[coco2hico[object_idx]]
        sio.savemat(
            os.path.join(cache_dir, f"detections_{object_idx.zfill(2)}.mat"),
            dict(all_boxes=all_results[interaction_idx]),
        )


def cache_vcoco_pkl(eval_step, params, loader, dataset, cache_dir: str) -> str:
    """Run inference and write ``vcoco_results.pkl`` rows."""
    os.makedirs(cache_dir, exist_ok=True)
    all_results = []
    for batch, indices in loader:
        out = to_numpy(eval_step(params, batch))
        for slot, ds_index in enumerate(indices):
            res = unpack_image_results(out, batch, slot)
            image_id = dataset.image_id(ds_index)
            for bh, bo, s, a in zip(
                res["boxes_h"], res["boxes_o"], res["scores"], res["prediction"]
            ):
                a_name = dataset.actions[int(a)].split()
                row = CacheTemplate(image_id=int(image_id), person_box=bh.tolist())
                row[a_name[0] + "_agent"] = float(s)
                row["_".join(a_name)] = bo.tolist() + [float(s)]
                all_results.append(row)

    path = os.path.join(cache_dir, "vcoco_results.pkl")
    with open(path, "wb") as f:
        pickle.dump(all_results, f, 2)
    return path
