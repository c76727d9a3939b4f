"""HICO-DET mAP evaluation (the reference ``utils.test`` flow, batched).

Reference (``utils.py:148-198`` + ``test/adamixer_transH_spatital_r50_test.py``):
run inference, expand each box pair over its valid verbs, map (object, verb)
-> interaction id, greedily associate detections with GT pairs at min-IoU 0.5
per interaction class, and feed a 600-class 11-point AP meter whose recall
denominators are the dataset's per-class GT counts; report full / rare
(<10 GT) / non-rare means.

The reference fixes inference batch size at 1 (``utils.py:167``); here the
forward is batched and only the meter bookkeeping walks images on host.
Mirrors ``skghoi_tpu.eval.hoi_eval``; :func:`to_numpy` brings a batch's
outputs to the host in one pass.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from skghoi_torch.models.interaction_head import InteractionOutputs
from skghoi_torch.ops.ap import BoxPairAssociation, DetectionAPMeter


def unpack_image_results(
    out: InteractionOutputs, batch, i: int, max_pairs_keep: Optional[int] = None
) -> dict:
    """Extract one image's ragged results from the padded outputs.

    Returns boxes in **original image space** (transform postprocess,
    ``transforms.py:55-68``) and the expanded (pair, verb, score) triplets
    over nonzero-prior entries, like the reference result dicts
    (``heads/...head.py:291-337``).
    """
    scores = np.asarray(out.scores[i])  # [H, N, K]
    prior_h = np.asarray(out.prior[i, 0])
    pair_valid = np.asarray(out.pair_valid[i])
    boxes = np.asarray(out.boxes[i])  # resized space
    labels = np.asarray(out.object_class[i])
    weights = np.asarray(out.weights[i])

    ih, iw = np.asarray(batch.image_sizes[i])
    oh, ow = np.asarray(batch.original_sizes[i])
    sx, sy = ow / iw, oh / ih
    boxes_orig = boxes * np.asarray([sx, sy, sx, sy], np.float32)

    x, y, k = np.nonzero((prior_h > 0) & pair_valid[..., None])
    if max_pairs_keep is not None and len(x) > max_pairs_keep:
        top = np.argsort(-scores[x, y, k])[:max_pairs_keep]
        x, y, k = x[top], y[top], k[top]

    return dict(
        boxes_h=boxes_orig[x],
        boxes_o=boxes_orig[y],
        object=labels[y],
        prediction=k,
        scores=scores[x, y, k],
        pair_index=np.stack([x, y], axis=1),
        weights=weights[x, y],
    )


def evaluate_hicodet(
    eval_step,
    params,
    loader,
    dataset,
    log_fn=print,
    max_batches: Optional[int] = None,
) -> Dict[str, object]:
    """Full evaluation loop -> {'full', 'rare', 'non_rare', 'ap', 'seconds'}."""
    num_anno = np.asarray(dataset.anno_interaction)
    rare = np.nonzero(num_anno < 10)[0]
    non_rare = np.nonzero(num_anno >= 10)[0]

    associate = BoxPairAssociation(min_iou=0.5)
    meter = DetectionAPMeter(
        dataset.num_interaction_cls, num_gt=num_anno.tolist(), algorithm="11P"
    )
    o2i = np.asarray(
        [[i if i is not None else -1 for i in row] for row in dataset.object_n_verb_to_interaction]
    )

    t0 = time.time()
    for b_num, (batch, indices) in enumerate(loader):
        if max_batches is not None and b_num >= max_batches:
            break
        out = to_numpy(eval_step(params, batch))
        for slot, ds_index in enumerate(indices):
            res = unpack_image_results(out, batch, slot)
            target = dataset.raw_target(ds_index)
            gt_h = np.asarray(target["boxes_h"], np.float64).reshape(-1, 4)
            gt_o = np.asarray(target["boxes_o"], np.float64).reshape(-1, 4)
            # GT 1-based pixel indices -> coordinates (utils.py:124-127)
            gt_h[:, :2] -= 1
            gt_o[:, :2] -= 1
            gt_hoi = np.asarray(target["hoi"])

            interactions = o2i[res["object"], res["prediction"]]
            keep = interactions >= 0
            interactions = interactions[keep]
            scores = res["scores"][keep]
            bh, bo = res["boxes_h"][keep], res["boxes_o"][keep]

            labels = np.zeros_like(scores)
            for hoi_idx in np.unique(interactions):
                gt_sel = np.nonzero(gt_hoi == hoi_idx)[0]
                det_sel = np.nonzero(interactions == hoi_idx)[0]
                if len(gt_sel):
                    labels[det_sel] = associate(
                        (gt_h[gt_sel], gt_o[gt_sel]),
                        (bh[det_sel], bo[det_sel]),
                        scores[det_sel],
                    )
            meter.append(scores, interactions, labels)

    ap = meter.eval()
    seconds = time.time() - t0
    result = dict(
        full=float(ap.mean()),
        rare=float(ap[rare].mean()) if len(rare) else 0.0,
        non_rare=float(ap[non_rare].mean()) if len(non_rare) else 0.0,
        ap=ap,
        seconds=seconds,
    )
    log_fn(
        f"Full: {result['full']:.4f}, rare: {result['rare']:.4f}, "
        f"non-rare: {result['non_rare']:.4f} ({seconds:.1f}s)"
    )
    return result


def to_numpy(tree):
    """Every tensor of a (nested) NamedTuple / tuple / list / dict as a numpy
    array on the host, bfloat16 as float32 (numpy has no bfloat16).  The
    first copy waits for the stream; the rest find it drained."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*map(to_numpy, tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map(to_numpy, tree))
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree
