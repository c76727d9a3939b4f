"""The port's eleven KGE models held against the JAX package's, on the CPU.

Each model is built in both packages with the same hyper-parameters; the
JAX model's ``init`` tables go into the port's through
``weights.kge_state_dict``.  On the same numpy-drawn ids: ``score``,
``rank_scores``, ``score_one_side`` (both corruption sides, and mixed),
``rank_all_tails/heads`` (the models that have them), ``regularization``,
DistMult's ``l3_regularization`` and the margin mode of the translational
models agree at rtol 1e-5 / atol 1e-6; the gradients of a
``NegativeSampling`` loss (with L2 regularization, both batch kinds, TransR
also through its chunked ``score_chunk`` path) agree with ``jax.grad``
within 1e-5 of each tensor's largest gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skghoi_tpu.kge import losses as jlosses
from skghoi_tpu.kge import models as jmodels
from skghoi_tpu.kge.sampling import CorruptBatch as JaxCorruptBatch
from skghoi_tpu.kge.sampling import TripleBatch as JaxTripleBatch
from skghoi_tpu.kge.strategy import NegativeSampling as JaxNegativeSampling
from skghoi_torch.kge import losses, models
from skghoi_torch.kge.sampling import CorruptBatch, TripleBatch, batch_to
from skghoi_torch.kge.strategy import NegativeSampling
from skghoi_torch.weights import kge_state_dict

torch.set_num_threads(2)

E, R, B, K, DIM = 40, 5, 12, 6, 8
RTOL, ATOL = 1e-5, 1e-6
GRAD_TOL = 1e-5  # of each tensor's largest gradient

# name -> (class name, constructor keywords, loss of the gradient test)
CONFIGS = {
    "transe": ("TransE", dict(dim=DIM, p_norm=1, norm_flag=True), "margin"),
    "transe_p2_margin": ("TransE", dict(dim=DIM, p_norm=2, norm_flag=False, margin=6.0), "sigmoid"),
    "transh": ("TransH", dict(dim=DIM, p_norm=2, norm_flag=True), "margin"),
    "transh_margin": ("TransH", dict(dim=DIM, p_norm=1, norm_flag=False, margin=4.0), "sigmoid"),
    "transr": ("TransR", dict(dim_e=DIM, dim_r=6, p_norm=1, rand_init=True), "margin"),
    "transr_chunk": ("TransR", dict(dim_e=DIM, dim_r=6, p_norm=1, rand_init=True, score_chunk=16),
                     "margin"),
    "transr_margin": ("TransR", dict(dim_e=DIM, dim_r=DIM, p_norm=2, margin=5.0), "softplus"),
    "transd": ("TransD", dict(dim_e=DIM, dim_r=6, p_norm=1), "margin"),
    "transd_pad_margin": ("TransD", dict(dim_e=6, dim_r=DIM, p_norm=2, margin=3.0), "sigmoid"),
    "distmult": ("DistMult", dict(dim=DIM), "softplus"),
    "distmult_init": ("DistMult", dict(dim=DIM, margin=200.0, epsilon=2.0), "sigmoid"),
    "complex": ("ComplEx", dict(dim=DIM), "softplus"),
    "rescal": ("RESCAL", dict(dim=DIM), "margin"),
    "analogy": ("Analogy", dict(dim=DIM), "softplus"),
    "simple": ("SimplE", dict(dim=DIM), "softplus"),
    "rotate": ("RotatE", dict(dim=DIM, margin=6.0), "sigmoid"),
    "hole": ("HolE", dict(dim=DIM), "softplus"),
}
RANK_ALL = [n for n, (cls, _, _) in CONFIGS.items() if hasattr(getattr(jmodels, cls), "rank_all_tails")]
LOSS_PAIRS = {
    "margin": (jlosses.MarginLoss(margin=5.0), losses.MarginLoss(margin=5.0)),
    "sigmoid": (jlosses.SigmoidLoss(adv_temperature=1.0), losses.SigmoidLoss(adv_temperature=1.0)),
    "softplus": (jlosses.SoftplusLoss(), losses.SoftplusLoss()),
}


def build(name, seed=0):
    """(jax model, jax params, port model with the same tables)."""
    cls, kw, _ = CONFIGS[name]
    jm = getattr(jmodels, cls)(ent_tot=E, rel_tot=R, **kw)
    ids = jnp.zeros((1,), jnp.int32)
    params = jm.init(jax.random.PRNGKey(seed), ids, ids, ids)
    tm = getattr(models, cls)(ent_tot=E, rel_tot=R, **kw)
    tm.load_state_dict(kge_state_dict(params))
    return jm, params, tm


def ids(seed=0):
    rng = np.random.default_rng(seed)
    return dict(h=rng.integers(0, E, B), t=rng.integers(0, E, B), r=rng.integers(0, R, B),
                neg=rng.integers(0, E, (B, K)), ct=rng.integers(0, 2, B).astype(bool),
                grid_h=rng.integers(0, E, (B, K)), grid_t=rng.integers(0, E, (B, K)),
                grid_r=rng.integers(0, R, (B, K)))


def close(got, want, rtol=RTOL, atol=ATOL):
    want = want.detach().numpy() if torch.is_tensor(want) else np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol, atol=atol)


J = lambda x: jnp.asarray(x, jnp.int32)  # noqa: E731
T = torch.from_numpy  # noqa: E731


@pytest.mark.parametrize("name", list(CONFIGS))
def test_score_rank_scores_regularization(name):
    jm, params, tm = build(name)
    x = ids(1)
    for h, t, r in ((x["h"], x["t"], x["r"]), (x["grid_h"], x["grid_t"], x["grid_r"]),
                    (x["h"][:, None], x["neg"], x["r"][:, None])):  # broadcast ids
        close(tm(T(h), T(t), T(r)), jm.apply(params, J(h), J(t), J(r)))
        close(tm.rank_scores(T(h), T(t), T(r)),
              jm.apply(params, J(h), J(t), J(r), method="rank_scores"))
    close(tm.regularization(T(x["h"]), T(x["t"]), T(x["r"])),
          jm.apply(params, J(x["h"]), J(x["t"]), J(x["r"]), method="regularization"))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_score_one_side(name):
    jm, params, tm = build(name)
    x = ids(2)
    for ct in (x["ct"], np.ones(B, bool), np.zeros(B, bool)):
        got = tm.score_one_side(T(x["h"]), T(x["t"]), T(x["r"]), T(x["neg"]), T(ct))
        want = jm.apply(params, J(x["h"]), J(x["t"]), J(x["r"]), J(x["neg"]), jnp.asarray(ct),
                        method="score_one_side")
        assert got.shape == (B, K)
        close(got, want)


@pytest.mark.parametrize("name", RANK_ALL)
def test_rank_all(name):
    jm, params, tm = build(name)
    x = ids(3)
    for method in ("rank_all_tails", "rank_all_heads"):
        want = jax.vmap(lambda a, r: jm.apply(params, a, r, method=method))(J(x["h"]), J(x["r"]))
        got = getattr(tm, method)(T(x["h"]), T(x["r"]))
        assert got.shape == (B, E)
        close(got, want)


def test_l3_regularization():
    for name in ("distmult", "distmult_init"):
        jm, params, tm = build(name)
        close(tm.l3_regularization(), jm.apply(params, method="l3_regularization"), rtol=1e-5)


def test_margin_mode_ranks_by_distance():
    """With a margin the training score is ``margin - distance`` and
    ``rank_scores`` is the distance, in both packages."""
    _, _, plain = build("transe")
    jm, params, tm = build("transe_p2_margin")
    x = ids(4)
    h, t, r = T(x["h"]), T(x["t"]), T(x["r"])
    close(tm(h, t, r), 6.0 - tm.rank_scores(h, t, r), rtol=1e-6)
    close(tm.rank_scores(h, t, r),
          jm.apply(params, J(x["h"]), J(x["t"]), J(x["r"]), method="rank_scores"))
    assert plain.margin is None and torch.equal(plain(h, t, r), plain.rank_scores(h, t, r))


def _batches(x):
    triple = TripleBatch(x["h"], x["t"], x["r"], x["grid_h"], x["grid_t"],
                         np.broadcast_to(x["r"][:, None], (B, K)).copy())
    corrupt = CorruptBatch(x["h"], x["t"], x["r"], x["neg"], x["ct"])
    jax_triple = JaxTripleBatch(*(J(v) for v in triple))
    jax_corrupt = JaxCorruptBatch(*(J(v) for v in corrupt[:4]), jnp.asarray(x["ct"]))
    return {"normal": (triple, jax_triple), "oneside": (corrupt, jax_corrupt)}


@pytest.mark.parametrize("mode", ["normal", "oneside"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_negative_sampling_gradients(name, mode):
    jm, params, tm = build(name)
    jloss, tloss = LOSS_PAIRS[CONFIGS[name][2]]
    l3 = 1e-3 if name.startswith("distmult") else 0.0
    jstrat = JaxNegativeSampling(loss=jloss, regul_rate=0.1, l3_regul_rate=l3)
    tstrat = NegativeSampling(loss=tloss, regul_rate=0.1, l3_regul_rate=l3)
    batch, jbatch = _batches(ids(5))[mode]

    jl, jgrads = jax.value_and_grad(lambda p: jstrat(jm, p, jbatch))(params)
    loss = tstrat(tm, batch_to(batch, "cpu"))
    loss.backward()
    close(loss, jl)
    want = kge_state_dict(jgrads)
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert got.keys() == want.keys()
    assert all(want[n].abs().max() > 0 for n in want)
    for n, g in got.items():
        scale = want[n].abs().max().item()
        err = (g - want[n]).abs().max().item()
        assert err <= GRAD_TOL * scale, (n, err, scale)
