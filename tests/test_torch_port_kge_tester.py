"""The port's KGE tester held against the JAX package's ``Tester``, on the CPU.

For each of the eleven models, with the JAX tables carried over by
``weights.kge_state_dict``, on a 40-entity KG with valid/test splits and
type constraints: the raw, filtered and type-constrained (filtered) ranks
of every test triple, both sides, equal JAX's.  A rank may differ only where
the ground truth's score ties another entity's within float32 rounding (the
two packages sum in different orders); such cases are counted and must stay
below 2% of the ranks.  MRR / MR / Hits@{10,3,1} of ``run_link_prediction``
(with and without type constraints) agree within 1e-6, and triple
classification gives the same threshold (rtol 1e-5) and accuracy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skghoi_tpu.kge import Tester as JaxTester
from skghoi_tpu.kge import models as jmodels
from skghoi_tpu.kge.data import KGData as JaxKGData
from skghoi_torch.kge import models
from skghoi_torch.kge import Tester as KGETester
from skghoi_torch.kge.data import KGData
from skghoi_torch.weights import kge_state_dict

torch.set_num_threads(2)

E, R, DIM, CHUNK = 40, 4, 8, 8
MODELS = {
    "transe": ("TransE", dict(dim=DIM, p_norm=1)),
    "transh_margin": ("TransH", dict(dim=DIM, p_norm=2, margin=4.0)),
    "transr": ("TransR", dict(dim_e=DIM, dim_r=6, rand_init=True)),
    "transd": ("TransD", dict(dim_e=DIM, dim_r=DIM)),
    "distmult": ("DistMult", dict(dim=DIM)),
    "complex": ("ComplEx", dict(dim=DIM)),
    "rescal": ("RESCAL", dict(dim=DIM)),
    "analogy": ("Analogy", dict(dim=DIM)),
    "simple": ("SimplE", dict(dim=DIM)),
    "rotate": ("RotatE", dict(dim=DIM)),
    "hole": ("HolE", dict(dim=DIM)),
}


def kg_pair():
    """The same KG in both packages: 300 triples split 240/20/40, with type
    constraints (the entities seen in each relation's slot, plus a few)."""
    rng = np.random.default_rng(0)
    triples = np.unique(np.stack([rng.integers(0, E, 300), rng.integers(0, E, 300),
                                  rng.integers(0, R, 300)], 1), axis=0)
    triples = triples[rng.permutation(len(triples))]
    split = dict(train=triples[:240], valid=triples[240:260], test=triples[260:300])
    out = []
    for cls in (KGData, JaxKGData):
        data = cls.build(E, R, split["train"], split["valid"], split["test"])
        data.head_type = {r: np.unique(np.r_[triples[triples[:, 2] == r, 0], [r, r + 5]])
                          for r in range(R - 1)}  # the last relation admits no entity
        data.tail_type = {r: np.unique(np.r_[triples[triples[:, 2] == r, 1], [2 * r]])
                          for r in range(R - 1)}
        out.append(data)
    return out


def build(name):
    cls, kw = MODELS[name]
    jm = getattr(jmodels, cls)(ent_tot=E, rel_tot=R, **kw)
    z = jnp.zeros((1,), jnp.int32)
    params = jm.init(jax.random.PRNGKey(1), z, z, z)
    tm = getattr(models, cls)(E, R, **kw)
    tm.load_state_dict(kge_state_dict(params))
    return jm, params, tm


def jax_ranks(tester, data):
    """JAX's per-triple ranks, chunk by chunk as its run_link_prediction
    takes them (type-constrained masks on)."""
    out = {k: [] for k in ("head_raw", "head_filt", "head_cons", "tail_raw", "tail_filt",
                           "tail_cons")}
    C = tester.chunk_size
    for start in range(0, len(data.test), C):
        chunk = data.test[start:start + C]
        n = len(chunk)
        chunk = np.concatenate([chunk, np.repeat(chunk[-1:], C - n, 0)])
        h, t, r = (jnp.asarray(chunk[:, i], jnp.int32) for i in range(3))
        (hr, hf, _, hcf), (tr, tf, _, tcf) = tester._chunk_ranks(
            tester.params, h, t, r, None, tester._type_masks(chunk[:, 2]))
        for k, v in zip(out, (hr, hf, hcf, tr, tf, tcf)):
            out[k].append(np.asarray(v)[:n])
    return {k: np.concatenate(v) for k, v in out.items()}


def jax_scores(jm, params, data):
    """``[N, E]`` JAX rank scores of every test triple's head and tail side."""
    h, t, r = (jnp.asarray(data.test[:, i], jnp.int32) for i in range(3))
    ents = jnp.broadcast_to(jnp.arange(E, dtype=jnp.int32), (len(h), E))
    bc = lambda x: jnp.broadcast_to(x[:, None], ents.shape)  # noqa: E731
    heads = jm.apply(params, ents, bc(t), bc(r), method="rank_scores")
    tails = jm.apply(params, bc(h), ents, bc(r), method="rank_scores")
    return {"head": np.asarray(heads), "tail": np.asarray(tails)}


@pytest.mark.parametrize("name", list(MODELS))
def test_ranks_equal_jax(name):
    data, jdata = kg_pair()
    jm, params, tm = build(name)
    got = KGETester(tm, data, chunk_size=CHUNK).ranks(type_constrain=True)
    want = jax_ranks(JaxTester(jm, params, jdata, chunk_size=CHUNK), jdata)
    scores = jax_scores(jm, params, jdata)
    ties = 0
    for key, w in want.items():
        side = key.split("_")[0]
        gt = data.test[:, 0 if side == "head" else 1]
        for i in np.flatnonzero(got[key] != w):
            row = scores[side][i]
            near = np.abs(row - row[gt[i]]) <= 2.0 ** -20 * np.abs(row).max()
            near[gt[i]] = False
            assert near.any(), (key, i, got[key][i], w[i])  # only a float tie may differ
            assert abs(int(got[key][i]) - int(w[i])) <= near.sum(), (key, i)
            ties += 1
    assert ties <= 0.02 * len(data.test) * len(want), ties
    assert (want["head_cons"] <= want["head_filt"]).all() and (want["head_filt"] <= want["head_raw"]).all()


@pytest.mark.parametrize("name", ["transe", "distmult", "rescal", "rotate"])
def test_link_prediction_metrics_and_classification(name):
    data, jdata = kg_pair()
    jm, params, tm = build(name)
    tester, jtester = KGETester(tm, data, chunk_size=CHUNK), JaxTester(jm, params, jdata, chunk_size=CHUNK)
    for type_constrain in (False, True):
        got = tester.run_link_prediction(type_constrain=type_constrain, log_fn=lambda s: None)
        want = jtester.run_link_prediction(type_constrain=type_constrain, log_fn=lambda s: None)
        np.testing.assert_allclose(tuple(got), tuple(want), rtol=0, atol=1e-6)
        for k in want.raw:
            assert abs(got.raw[k] - want.raw[k]) <= 1e-6, k
    acc, thr = tester.run_triple_classification(seed=3)
    jacc, jthr = jtester.run_triple_classification(seed=3)
    assert acc == jacc
    np.testing.assert_allclose(thr, jthr, rtol=1e-5)
    acc_given, _ = tester.run_triple_classification(threshold=thr, seed=5)
    jacc_given, _ = jtester.run_triple_classification(threshold=thr, seed=5)
    assert acc_given == jacc_given
