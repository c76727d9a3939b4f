"""The port's V-COCO role-AP evaluation held against the JAX package's.

The four known-answer cases of ``tests/test_vcoco_known_answers.py`` (the
official evaluator's covered-GT argmax rule, the empty-role scenarios, the
recall denominator) and the synthetic round trip of
``tests/test_vcoco_loop.py`` (generator -> dataset -> perfect results ->
role AP 1.0), through the port's ``eval/vcoco_eval.py`` and
``tools/vcoco_evaluation.py``: per-action agent / scenario-1 / scenario-2 AP
equal to JAX's exactly, on the same pickle.
"""

import os
import pickle

import numpy as np
import pytest

from skghoi_tpu.data.synthetic import make_synthetic_vcoco as jax_make_synthetic_vcoco
from skghoi_tpu.data.vcoco import VCOCO as JaxVCOCO
from skghoi_tpu.eval.vcoco_eval import VCOCOeval as JaxVCOCOeval
from skghoi_torch.data.synthetic import make_synthetic_vcoco
from skghoi_torch.data.vcoco import VCOCO
from skghoi_torch.eval.cache import CacheTemplate
from skghoi_torch.eval.vcoco_eval import VCOCOeval
from skghoi_torch.tools import vcoco_evaluation


class FakeVCOCO:
    """Minimal duck-typed stand-in for data.vcoco.VCOCO."""

    def __init__(self, targets, actions):
        self._targets = targets
        self._actions = actions

    def __len__(self):
        return len(self._targets)

    def raw_target(self, i):
        return self._targets[i]

    def image_id(self, i):
        return self._targets[i]["image_id"]

    @property
    def actions(self):
        return list(self._actions)


def both(targets, dets, tmp_path, actions=("hold obj",)):
    """The port's result, after asserting it equals JAX's exactly."""
    ds = FakeVCOCO(targets, actions)
    det_file = tmp_path / "dets.pkl"
    with open(det_file, "wb") as f:
        pickle.dump(dets, f)
    got = VCOCOeval(ds)._do_eval(str(det_file))
    want = JaxVCOCOeval(ds)._do_eval(str(det_file))
    assert got == want
    return got


ROLE = [50, 50, 60, 60]


def _det(pbox, s, role=ROLE):
    return dict(image_id=1, person_box=pbox, hold_obj=list(role) + [s], hold_agent=s)


def test_perfect_single_detection(tmp_path):
    targets = [dict(image_id=1, boxes_h=[[0, 0, 10, 10]], boxes_o=[ROLE], actions=[0])]
    r = both(targets, [_det([0, 0, 10, 10], 0.9)], tmp_path)["per_action"]["hold obj"]
    assert r["scenario_1"] == r["scenario_2"] == r["agent"] == 1.0


def test_covered_gt_argmax_rule(tmp_path):
    """D2's best joint overlap is the covered G1 -> FP; AP = 5/6."""
    targets = [dict(image_id=1, boxes_h=[[0, 0, 10, 10], [4, 0, 14, 10]], boxes_o=[ROLE, ROLE],
                    actions=[0, 0])]
    dets = [_det([0, 0, 10, 10], 0.9), _det([1, 0, 11, 10], 0.8), _det([4, 0, 14, 10], 0.7)]
    res = both(targets, dets, tmp_path)["per_action"]["hold obj"]
    for key in ("scenario_1", "scenario_2", "agent"):
        np.testing.assert_allclose(res[key], 5.0 / 6.0, rtol=1e-9, err_msg=key)


@pytest.mark.parametrize("role, s1", [([0.0, 0.0, 0.1, 0.1], 0.0), ([0.0] * 4, 1.0),
                                      ([np.nan] * 4, 1.0)], ids=["tiny", "zero", "nan"])
def test_empty_role_scenarios(tmp_path, role, s1):
    """Missing GT role: scenario 1 needs an all-zero/NaN role box (the tiny
    CacheTemplate default fails); scenario 2 always grants the role."""
    targets = [dict(image_id=1, boxes_h=[[0, 0, 10, 10]], boxes_o=[[0, 0, 0, 0]], actions=[0])]
    res = both(targets, [_det([0, 0, 10, 10], 0.9, role)], tmp_path)["per_action"]["hold obj"]
    assert res["scenario_1"] == s1 and res["scenario_2"] == 1.0


def test_missing_role_counts_in_recall_denominator(tmp_path):
    targets = [dict(image_id=1, boxes_h=[[0, 0, 10, 10], [30, 0, 40, 10]],
                    boxes_o=[ROLE, [0, 0, 0, 0]], actions=[0, 0])]
    res = both(targets, [_det([0, 0, 10, 10], 0.9)], tmp_path)["per_action"]["hold obj"]
    np.testing.assert_allclose(res["scenario_1"], 0.5)
    np.testing.assert_allclose(res["scenario_2"], 0.5)


def test_synthetic_vcoco_roundtrip(tmp_path):
    root = str(tmp_path)
    make_synthetic_vcoco(root, "test", num_images=5)
    jroot = str(tmp_path / "jax")
    jax_make_synthetic_vcoco(jroot, "test", num_images=5)
    for name in ("instances_vcoco_test.json",):
        with open(os.path.join(root, name), "rb") as a, open(os.path.join(jroot, name), "rb") as b:
            assert a.read() == b.read()
    args = dict(root=os.path.join(root, "mscoco2014/val2014"),
                anno_file=os.path.join(root, "instances_vcoco_test.json"))
    ds, jds = VCOCO(**args), JaxVCOCO(**args)
    assert len(ds) == 5 and len(ds.actions) == 24 and ds.object_verb_mask().shape == (80, 24)

    rng = np.random.default_rng(0)
    rows = []
    for i in range(len(ds)):
        t = ds.raw_target(i)
        for bh, bo, a in zip(t["boxes_h"], t["boxes_o"], t["actions"]):
            name = ds.actions[a].split()
            r = CacheTemplate(image_id=ds.image_id(i), person_box=list(bh))
            r[name[0] + "_agent"] = 0.9
            r["_".join(name)] = list(bo) + [0.9]
            rows.append(r)
            # A jittered, lower-scored duplicate: APs below 1 exercise the ranking.
            d = CacheTemplate(image_id=ds.image_id(i),
                              person_box=list(np.asarray(bh) + rng.normal(0, 8, 4)))
            d[name[0] + "_agent"] = float(rng.uniform(0.1, 0.95))
            d["_".join(name)] = list(np.asarray(bo) + rng.normal(0, 8, 4)) + [d[name[0] + "_agent"]]
            rows.append(d)
    det = os.path.join(root, "res.pkl")
    with open(det, "wb") as f:
        pickle.dump(rows, f, 2)

    got = VCOCOeval(ds)._do_eval(det)
    want = JaxVCOCOeval(jds)._do_eval(det)
    assert got["per_action"] == want["per_action"] and got["mean"] == want["mean"]
    assert got["mean"]["agent"] > 0.5
    cli = vcoco_evaluation.main(["--data-root", root, "--det-file", det])
    assert cli == got
