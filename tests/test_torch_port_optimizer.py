"""The port's optimizer and train step against ``optax`` and the JAX step.

1. ``build_optimizer`` against ``skghoi_tpu.train.optimizer.build_optimizer``
   on a small parameter tree with detector, head and frozen parameters: three
   steps across a milestone, within 1e-6.
2. The NaN guard: after a non-finite loss or gradient the parameters and the
   whole optimizer state (moments, step counts, the schedule's count) are
   bit-for-bit what they were, the gradients are zero, and the next finite
   step proceeds as if the bad one never happened.
3. The three ``loss_keys`` variants against the JAX ``build_train_step``.
"""

import copy
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from skghoi_tpu.parallel.train_step import build_train_step as jax_build_train_step
from skghoi_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from skghoi_torch.parallel.train_step import build_train_step
from skghoi_torch.train.optimizer import build_optimizer

torch.set_num_threads(2)

TOL = dict(rtol=1e-6, atol=1e-6)

# port parameter name -> path in the JAX tree (elementwise optimizers: the
# layout of each leaf does not matter, so both sides hold the same arrays).
PARAMS = {
    "detector.backbone.conv1.weight": ("detector", "backbone", "stem_conv", "kernel"),
    "detector.backbone.layer1.0.weight": ("detector", "backbone", "layer1_block0", "kernel"),
    "detector.backbone.layer2.0.weight": ("detector", "backbone", "layer2_block0", "kernel"),
    "detector.neck.lateral.weight": ("detector", "neck", "lateral0", "kernel"),
    "interaction_head.fc.weight": ("interaction_head", "fc", "kernel"),
    "interaction_head.fc.bias": ("interaction_head", "fc", "bias"),
}
FROZEN = ("detector.backbone.conv1.weight", "detector.backbone.layer1.0.weight")


def _tree_set(tree, path, value):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _tree_get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _toy_module(values):
    """A module whose parameter names are the keys of ``values``; the stem
    and ``layer1`` are frozen as ``frozen_stages=1`` freezes them."""
    root = nn.Module()
    for name, v in values.items():
        *mods, leaf = name.split(".")
        m = root
        for part in mods:
            if not hasattr(m, part):
                m.add_module(part, nn.Module())
            m = getattr(m, part)
        m.register_parameter(leaf, nn.Parameter(torch.from_numpy(v.copy()),
                                                requires_grad=name not in FROZEN))
    return root


def _values(seed):
    rng = np.random.default_rng(seed)
    return {name: rng.normal(size=(3, 4)).astype(np.float32) for name in PARAMS}


def test_optimizer_matches_optax_across_a_milestone():
    values = _values(0)
    rng = np.random.default_rng(1)
    grads = [{name: rng.normal(size=(3, 4)).astype(np.float32) for name in PARAMS}
             for _ in range(3)]
    kw = dict(learning_rate=1e-2, lr_decay=0.1, weight_decay=0.5, steps_per_epoch=2,
              milestones=(1,), milestone_gamma=0.1)

    params = {}
    for name, path in PARAMS.items():
        _tree_set(params, path, jnp.asarray(values[name]))
    tx = jax_build_optimizer(params, frozen_stages=1, **kw)
    state = tx.init(params)
    for g in grads:
        gtree = {}
        for name, path in PARAMS.items():
            _tree_set(gtree, path, jnp.asarray(g[name]))
        updates, state = tx.update(gtree, state, params)
        params = optax.apply_updates(params, updates)

    module = _toy_module(values)
    opt = build_optimizer(module, **kw)
    assert [g["name"] for g in opt.param_groups] == ["detector", "head"]
    assert [len(g["params"]) for g in opt.param_groups] == [2, 2]  # frozen ones in no group
    tparams = dict(module.named_parameters())
    lrs = []
    for g in grads:
        for name, p in tparams.items():
            if p.requires_grad:
                p.grad = torch.from_numpy(g[name])
        opt.step()
        lrs.append([group["lr"] for group in opt.param_groups])
    np.testing.assert_allclose(lrs, [[1e-3, 1e-2], [1e-3, 1e-2], [1e-4, 1e-3]], rtol=1e-12)
    assert [g["applied_steps"] for g in opt.param_groups] == [3, 3]
    for name, path in PARAMS.items():
        got = tparams[name].detach().numpy()
        np.testing.assert_allclose(got, np.asarray(_tree_get(params, path)), **TOL, err_msg=name)
        if name in FROZEN:
            np.testing.assert_array_equal(got, values[name])
        else:
            assert not np.allclose(got, values[name])


# --- toy models for the train step ---------------------------------------------

class _Out(NamedTuple):
    losses: dict


def _toy_losses(w, u, v, x, xp):
    """One parameter per loss, so each loss_keys variant moves its own."""
    return {"hoi_loss": xp.sum(w * x) ** 2 * 0.1,
            "interactiveness_loss": xp.sum(u * x * x),
            "transh_loss": xp.sum(v * x) + 0.5 * xp.sum(u * u)}


class _JaxToy:
    def apply(self, variables, batch, ovm, training=True, rng=None):
        p = variables["params"]
        return _Out(_toy_losses(p["w"], p["u"], p["v"], batch, jnp))


class _TorchToy(nn.Module):
    def __init__(self, values, root_term=False):
        super().__init__()
        self.w, self.u, self.v = (nn.Parameter(torch.from_numpy(values[k].copy())) for k in "wuv")
        self.root_term = root_term

    def forward(self, batch, ovm, *, training=False, generator=None, gumbel=None):
        losses = _toy_losses(self.w, self.u, self.v, batch, torch)
        if self.root_term:
            # Finite, but its gradient is not where the batch is 0:
            # d/dw |w x^2|^(1/4) = inf * 0 there.
            losses["hoi_loss"] = losses["hoi_loss"] + (self.w * batch * batch).abs().pow(0.25).sum()
        return _Out(losses)


def _toy_values():
    rng = np.random.default_rng(3)
    return {k: rng.normal(size=3).astype(np.float32) for k in "wuv"}


@pytest.mark.parametrize("loss_keys", [None, ("transh_loss",), ("hoi_loss", "interactiveness_loss")],
                         ids=["all", "transh", "no_transh"])
def test_loss_keys_match_jax(loss_keys):
    values = _toy_values()
    batches = [np.asarray([0.5, -1.0, 2.0], np.float32), np.asarray([1.5, 0.3, -0.7], np.float32)]
    lr, wd = 1e-2, 0.1

    params = {k: jnp.asarray(v) for k, v in values.items()}
    tx = optax.adamw(lr, weight_decay=wd)
    state = tx.init(params)
    jstep = jax_build_train_step(_JaxToy(), tx, np.ones((2, 2)), loss_keys=loss_keys, donate=False)
    jtotals = []
    for x in batches:
        params, state, total, _, _ = jstep(params, {}, state, jnp.asarray(x), jax.random.PRNGKey(0))
        jtotals.append(float(total))

    model = _TorchToy(values)
    opt = build_optimizer(model, learning_rate=lr, weight_decay=wd)
    step = build_train_step(model, opt, torch.ones(2, 2), loss_keys=loss_keys)
    for x, want in zip(batches, jtotals):
        total, losses, _, applied = step(torch.from_numpy(x))
        assert applied
        np.testing.assert_allclose(float(total), want, rtol=1e-6)
    for k in "wuv":
        np.testing.assert_allclose(getattr(model, k).detach().numpy(), np.asarray(params[k]), **TOL,
                                   err_msg=k)


def _guard_setup():
    model = _TorchToy(_toy_values(), root_term=True)
    opt = build_optimizer(model, learning_rate=1e-2, weight_decay=0.1, steps_per_epoch=1,
                          milestones=(2,))
    return model, opt, build_train_step(model, opt, torch.ones(2, 2))


def _snapshot(model, opt):
    return ({n: p.detach().clone() for n, p in model.named_parameters()},
            copy.deepcopy(opt.state_dict()))


def _assert_same_state(a, b):
    pa, sa = a
    pb, sb = b
    for n in pa:
        assert torch.equal(pa[n], pb[n]), n
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["state"].keys() == sb["state"].keys() and sa["state"]
    for i in sa["state"]:
        for k, v in sa["state"][i].items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)


@pytest.mark.parametrize("bad", ["nan_loss", "nonfinite_grad"])
def test_nan_guard_leaves_everything_unchanged(bad):
    model, opt, step = _guard_setup()
    good = torch.tensor([0.5, -1.0, 2.0])
    assert step(good)[3]  # the optimizer now has moments and a step count
    before = _snapshot(model, opt)

    x = torch.tensor([0.5, float("nan"), 2.0]) if bad == "nan_loss" else torch.tensor([0.5, 0.0, 2.0])
    total, losses, _, applied = step(x)
    assert not applied
    assert torch.isfinite(total).item() == (bad == "nonfinite_grad")
    _assert_same_state(before, _snapshot(model, opt))
    assert all(not p.grad.any() for p in model.parameters())
    assert [g["applied_steps"] for g in opt.param_groups] == [1]

    # The schedule did not advance: the next good steps equal those of a run
    # that never saw the bad batch, milestone included.
    ref_model, ref_opt, ref_step = _guard_setup()
    ref_step(good)
    for _ in range(2):
        assert step(good)[3] and ref_step(good)[3]
    _assert_same_state(_snapshot(ref_model, ref_opt), _snapshot(model, opt))
    assert opt.param_groups[0]["lr"] == pytest.approx(1e-3)  # past the milestone at step 2
