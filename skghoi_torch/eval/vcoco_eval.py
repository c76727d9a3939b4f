"""V-COCO role-AP evaluator (scenario 1 and 2), replacing ``vsrl_eval``.

The reference defers to the official V-COCO evaluator from its (absent)
``vcoco`` submodule: ``VCOCOeval(...)._do_eval(det_file, ovr_thresh=0.5)``
(``vcoco_evaluation.py:1-10``).  This module ports the official
``vsrl_eval._do_role_eval`` / ``_do_agent_eval`` matching semantics (Gupta &
Malik, "Visual Semantic Role Labeling") precisely:

For each action with a role, detections are (person_box, role_box, score)
triples ranked by score over the whole test set.  For each detection, every
GT instance of (image, action) — including already-covered ones — gets a
joint overlap:

- person overlap ``ov = IoU(person_box, gt_person)``;
- role overlap ``ov_role``: when the GT role is missing, **scenario 1**
  demands an *empty* prediction (all-zero or all-NaN role box -> 1.0, else
  0.0; the CacheTemplate's ``[0, 0, .1, .1]`` tiny box deliberately fails
  this, as in the official evaluator), **scenario 2** grants 1.0
  unconditionally; otherwise ``IoU(role_box, gt_role)``;
- the detection is assigned ``jmax = argmax_j min(ov_j, ov_role_j)``.

If ``max min-overlap >= ovr_thresh``: TP when ``jmax`` is uncovered (then
covered), FP when it is — even if another uncovered GT also passes.  AP is
the all-point precision-envelope integral (``voc_ap``); the recall
denominator counts every positive GT instance, including missing-role ones.
Agent AP matches on person IoU alone with the same argmax-then-covered rule.

GT comes from our V-COCO annotation JSON (``instances_vcoco_test.json``):
per image ``boxes_h``, ``boxes_o`` (zero rows = missing role) and
``actions``.  Host numpy over the cached pickle; a copy of
``skghoi_tpu.eval.vcoco_eval``'s arithmetic.
"""

from __future__ import annotations

import pickle
from collections import defaultdict
from typing import Dict, List

import numpy as np

from skghoi_torch.data.vcoco import VCOCO
from skghoi_torch.ops.ap import _np_box_iou, ap_from_pr


def _is_empty_box(box: np.ndarray) -> bool:
    """Official vsrl_eval empty-role test: all-zero or all-NaN role box.
    (The CacheTemplate tiny ``[0, 0, .1, .1]`` default is NOT empty — the
    official evaluator counts it as a role prediction.)"""
    b = np.asarray(box, np.float64).reshape(-1)[:4]
    return bool(np.all(b == 0.0) or np.all(np.isnan(b)))


class VCOCOeval:
    def __init__(self, dataset: VCOCO):
        self.dataset = dataset
        # GT indexed by (image_id, action): list of (person_box, role_box)
        self.gt: Dict[tuple, List] = defaultdict(list)
        for i in range(len(dataset)):
            t = dataset.raw_target(i)
            img_id = dataset.image_id(i)
            bh = np.asarray(t["boxes_h"], np.float64).reshape(-1, 4)
            bo = np.asarray(t["boxes_o"], np.float64).reshape(-1, 4)
            for a, (hb, ob) in zip(t["actions"], zip(bh, bo)):
                self.gt[(img_id, int(a))].append((hb, ob))

    def _do_eval(self, det_file: str, ovr_thresh: float = 0.5) -> Dict[str, Dict[str, float]]:
        with open(det_file, "rb") as f:
            dets = pickle.load(f)

        actions = self.dataset.actions
        results = {}
        for a_idx, a_full in enumerate(actions):
            parts = a_full.split()
            verb = parts[0]
            role_key = "_".join(parts)
            agent_key = verb + "_agent"

            # Collect detections for this action.
            rows = []
            for d in dets:
                score_agent = d.get(agent_key, 0.0) if isinstance(d, dict) else d[agent_key]
                role = d[role_key] if role_key in d else None
                if role is None:
                    continue
                role = np.asarray(role, np.float64)
                rows.append(
                    (
                        d["image_id"],
                        np.asarray(d["person_box"], np.float64),
                        role[:4],
                        float(role[4]) if len(role) > 4 else float(score_agent),
                        float(score_agent),
                    )
                )
            n_gt = sum(len(v) for (img, a), v in self.gt.items() if a == a_idx)
            if n_gt == 0:
                continue

            res_a = {}
            for scenario in (1, 2):
                order = np.argsort(-np.asarray([r[3] for r in rows], np.float64), kind="stable")
                covered = defaultdict(set)
                tp = np.zeros(len(rows))
                fp = np.zeros(len(rows))
                for rank, ri in enumerate(order):
                    img_id, pbox, rbox, _score, _ = rows[ri]
                    gts = self.gt.get((img_id, a_idx), [])
                    # argmax over ALL gt (covered included) of min(ov, ov_role)
                    ovmax, jmax = -np.inf, -1
                    for j, (ghb, gob) in enumerate(gts):
                        ov_p = _np_box_iou(pbox[None], ghb[None])[0, 0]
                        if _is_empty_box(gob):
                            if scenario == 1:
                                ov_role = 1.0 if _is_empty_box(rbox) else 0.0
                            else:
                                ov_role = 1.0
                        else:
                            ov_role = _np_box_iou(rbox[None], gob[None])[0, 0]
                        min_ov = min(ov_p, ov_role)
                        if min_ov > ovmax:
                            ovmax, jmax = min_ov, j
                    if ovmax >= ovr_thresh and jmax not in covered[img_id]:
                        covered[img_id].add(jmax)
                        tp[rank] = 1
                    else:
                        fp[rank] = 1
                ctp, cfp = np.cumsum(tp), np.cumsum(fp)
                rec = ctp / n_gt
                prec = ctp / np.maximum(ctp + cfp, 1e-12)
                res_a[f"scenario_{scenario}"] = ap_from_pr(prec, rec, "INT")

            # Agent AP: person IoU argmax, same covered rule (_do_agent_eval)
            order = np.argsort(-np.asarray([r[4] for r in rows], np.float64), kind="stable")
            covered = defaultdict(set)
            tp = np.zeros(len(rows))
            fp = np.zeros(len(rows))
            for rank, ri in enumerate(order):
                img_id, pbox, _, _, _score = rows[ri]
                gts = self.gt.get((img_id, a_idx), [])
                ovmax, jmax = -np.inf, -1
                for j, (ghb, _g) in enumerate(gts):
                    ov = _np_box_iou(pbox[None], ghb[None])[0, 0]
                    if ov > ovmax:
                        ovmax, jmax = ov, j
                if ovmax >= ovr_thresh and jmax not in covered[img_id]:
                    covered[img_id].add(jmax)
                    tp[rank] = 1
                else:
                    fp[rank] = 1
            ctp, cfp = np.cumsum(tp), np.cumsum(fp)
            res_a["agent"] = ap_from_pr(
                ctp / np.maximum(ctp + cfp, 1e-12), ctp / n_gt, "INT"
            )
            results[a_full] = res_a

        mean = {
            k: float(np.mean([r[k] for r in results.values() if k in r]))
            for k in ("scenario_1", "scenario_2", "agent")
        }
        print("V-COCO role AP:")
        for name, r in results.items():
            print(
                f"  {name}: agent {r.get('agent', 0):.4f} | "
                f"S1 {r.get('scenario_1', 0):.4f} | S2 {r.get('scenario_2', 0):.4f}"
            )
        print(
            f"mean role AP — scenario 1: {mean['scenario_1']:.4f}, "
            f"scenario 2: {mean['scenario_2']:.4f}, agent: {mean['agent']:.4f}"
        )
        return {"per_action": results, "mean": mean}
