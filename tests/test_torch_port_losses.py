"""The port's three losses against ``skghoi_tpu.ops.losses`` on seeded inputs.

Values and gradients (with respect to the scores, logits and TransH
distances) agree within 1e-6, masked and unmasked, for every reduction;
an all-false mask gives exactly 0 in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skghoi_tpu.ops import losses as jl
from skghoi_torch.ops import losses as tl

torch.set_num_threads(2)

TOL = dict(rtol=1e-6, atol=1e-6)


def _inputs(seed, kind):
    rng = np.random.default_rng(seed)
    shape = (6, 40)
    y = (rng.uniform(size=shape) < 0.2).astype(np.float32)
    if kind == "scores":
        x = rng.uniform(0.0, 1.0, shape).astype(np.float32)
        x[0, :4] = [0.0, 1.0, 1e-7, 1 - 1e-7]  # at and beyond the clamp
    else:
        x = rng.normal(0.0, 4.0, shape).astype(np.float32)
        x[0, :2] = [-80.0, 80.0]
    masks = {"none": None, "random": rng.uniform(size=shape) < 0.6,
             "all_false": np.zeros(shape, bool)}
    return x, y, masks


def _jax_value_and_grad(fn, x, *args, **kwargs):
    value, grad = jax.value_and_grad(lambda a: fn(a, *args, **kwargs))(jnp.asarray(x))
    return np.asarray(value), np.asarray(grad)


def _torch_value_and_grad(fn, x, *args, **kwargs):
    t = torch.from_numpy(x).requires_grad_(True)
    value = fn(t, *args, **kwargs)
    value.backward()
    return value.detach().numpy(), t.grad.numpy()


@pytest.mark.parametrize("mask_kind", ["none", "random", "all_false"])
@pytest.mark.parametrize("reduction", ["sum", "mean"])
@pytest.mark.parametrize("name, kind, gamma", [
    ("binary_focal_loss", "scores", 0.2),
    ("binary_focal_loss", "scores", 2.0),
    ("binary_focal_loss_with_logits", "logits", 2.0),
    ("binary_focal_loss_with_logits", "logits", 0.2),
])
def test_focal_matches_jax(name, kind, gamma, reduction, mask_kind):
    x, y, masks = _inputs(0, kind)
    mask = masks[mask_kind]
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    want, want_g = _jax_value_and_grad(getattr(jl, name), x, jnp.asarray(y), gamma=gamma,
                                       reduction=reduction, mask=jm)
    got, got_g = _torch_value_and_grad(getattr(tl, name), x, torch.from_numpy(y), gamma=gamma,
                                       reduction=reduction, mask=tm)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got_g, want_g, **TOL)
    if mask_kind == "all_false":
        assert got == 0.0 and not got_g.any()


@pytest.mark.parametrize("mask_kind", ["none", "random", "all_false"])
def test_focal_unreduced_matches_jax(mask_kind):
    x, y, masks = _inputs(1, "logits")
    mask = masks[mask_kind]
    want = jl.binary_focal_loss_with_logits(jnp.asarray(x), jnp.asarray(y), reduction="none",
                                            mask=None if mask is None else jnp.asarray(mask))
    got = tl.binary_focal_loss_with_logits(torch.from_numpy(x), torch.from_numpy(y),
                                           reduction="none",
                                           mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mask_kind", ["none", "random", "all_false"])
def test_margin_ranking_matches_jax(mask_kind):
    rng = np.random.default_rng(2)
    pos = rng.uniform(0.0, 2.0, 64).astype(np.float32)
    neg = rng.uniform(0.0, 2.0, 64).astype(np.float32)
    pos[:3] = neg[:3] - 3.0  # clamped at -margin: no gradient there
    mask = {"none": None, "random": rng.uniform(size=64) < 0.5,
            "all_false": np.zeros(64, bool)}[mask_kind]

    def jfn(pn):
        return jl.margin_ranking_loss(pn[0], pn[1], margin=1.0,
                                      mask=None if mask is None else jnp.asarray(mask))

    def tfn(pn):
        return tl.margin_ranking_loss(pn[0], pn[1], margin=1.0,
                                      mask=None if mask is None else torch.from_numpy(mask))

    both = np.stack([pos, neg])
    want, want_g = _jax_value_and_grad(jfn, both)
    got, got_g = _torch_value_and_grad(tfn, both)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got_g, want_g, **TOL)
    if mask_kind == "all_false":
        assert got == 0.0 and not got_g.any()


def test_unknown_reduction_raises():
    with pytest.raises(ValueError, match="reduction"):
        tl.binary_focal_loss(torch.rand(3), torch.ones(3), reduction="max")
