"""The port's DETR in bfloat16 held against the JAX package's.

DETR (2+2 layers, 10 queries) at 64x96 with full widths: one JAX ``init``
is loaded into the port, and both packages run it with ``dtype`` bfloat16
and with float32.  Each bfloat16 output of the port is held against JAX's
bfloat16 output twice: within its tolerance in ``TOL`` (about twice the
larger of the two packages' own bfloat16-against-float32 gaps, the
measured values beside it), and within twice that larger gap as measured
in the same run.

- forwards: the logits and boxes and the post-processed boxes and scores
  (labels equal wherever JAX's two best classes are further apart than the
  scores may move), each relative to the output's largest;
- the set loss on shared assignments (JAX's bfloat16 matching, fed to
  every run);
- gradients: each parameter's, relative to its tensor's largest and as a
  relative norm, each within twice its own larger gap, the worst within
  ``GRAD_TOL`` and ``GRAD_NORM_TOL``.

Also: which tensors are bfloat16 and which float32 in both packages (port:
forward hooks; JAX: ``capture_intermediates`` and ``jax.eval_shape``), and
that the float32 default computes bit for bit what torch's stock layers
compute, as DETR did before it took ``dtype``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from skghoi_tpu.detect import detr as JD
from skghoi_torch.detect import detr as PD
from skghoi_torch.models import layers
from skghoi_torch.weights import detr_state_dict

torch.set_num_threads(2)

CANVAS = (64, 96)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}

# Each output's tolerance, relative to its largest (losses: relative), about
# twice the larger of the two packages' bfloat16-against-float32 gaps.
# Measured on the CPU: error of the bfloat16 port against bfloat16 JAX / that gap.
TOL = {
    "detr logits": 7e-3,          # 3.27e-3 / 3.82e-3
    "detr boxes": 2.8e-3,         # 1.47e-3 / 1.41e-3
    "detr post boxes": 2.8e-3,    # 1.45e-3 / 1.44e-3
    "detr post scores": 6e-3,     # 3.76e-3 / 6.78e-3
    "detr set loss": 2.7e-4,      # 7.0e-5 / 1.37e-4
}
# Gradients, each parameter's tensor, against its own larger gap: by the
# largest entry (relative to the tensor's largest) and by the norm of the
# difference (relative to the gradient's norm), each within twice that gap.
# At random init bfloat16 flips the sign of L1 terms and ReLU inputs near 0
# in both packages alike, so the largest-entry gaps are wide (up to 0.53,
# bbox_mlp.1.weight) and the worst tensor is held within GRAD_TOL (measured
# 0.43 there).  The norms are tighter: the worst tensor 0.179 (body.conv1.
# weight, gap 0.253), the median tensor 0.069, held within GRAD_NORM_TOL and
# GRAD_NORM_MEDIAN_TOL, so that a gradient at half its scale (0.5) or zero
# (1.0) fails in any tensor.
GRAD_TOL = 0.6
GRAD_NORM_TOL = 0.35
GRAD_NORM_MEDIAN_TOL = 0.14


def _rel(got, want, scale=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max() if scale is None else scale
    assert scale > 0
    return float(np.abs(got - want).max() / scale)


def _held(name, port, jax_out):
    """``port`` and ``jax_out`` map dtype name -> output: the bfloat16 port
    within ``TOL[name]`` of bfloat16 JAX, and within twice the larger of the
    two packages' bfloat16-against-float32 gaps."""
    err = _rel(port["bfloat16"], jax_out["bfloat16"])
    gap = max(_rel(port["bfloat16"], port["float32"]),
              _rel(jax_out["bfloat16"], jax_out["float32"]))
    assert err <= TOL[name] and err <= 2 * gap, (name, err, gap, TOL[name])


def _norm_rel(got, want, scale):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / scale)


def _grads_held(name, port, jax_grads):
    """Per parameter: the bfloat16 port's gradient against bfloat16 JAX's,
    by its largest entry and by its norm, each within twice the larger gap
    by the same measure; the worst within ``GRAD_TOL`` and
    ``GRAD_NORM_TOL``, the median norm within ``GRAD_NORM_MEDIAN_TOL``."""
    pb, pf, jb, jf = port["bfloat16"], port["float32"], jax_grads["bfloat16"], jax_grads["float32"]
    assert len(pb) > 30 and pb.keys() <= jb.keys() and pb.keys() == pf.keys()
    worst, worst_norm, norms = (0.0, None), (0.0, None), []
    for n in pb:
        sb, sf = np.abs(jb[n]).max(), np.abs(jf[n]).max()
        if sb == sf == 0:  # no gradient reaches it in JAX: none in the port either
            assert not pb[n].any() and not pf[n].any(), n
            continue
        err = _rel(pb[n], jb[n], sb)
        gap = max(_rel(pb[n], pf[n], sf), _rel(jb[n], jf[n], sf))
        assert err <= 2 * gap, (name, n, err, gap)
        worst = max(worst, (err, n))
        nb, nf = np.linalg.norm(np.asarray(jb[n], np.float64)), np.linalg.norm(jf[n])
        err = _norm_rel(pb[n], jb[n], nb)
        gap = max(_norm_rel(pb[n], pf[n], nf), _norm_rel(jb[n], jf[n], nf))
        assert err <= 2 * gap, (name, n, "norm", err, gap)
        worst_norm = max(worst_norm, (err, n))
        norms.append(err)
    assert worst[0] <= GRAD_TOL, (name, worst)
    assert worst_norm[0] <= GRAD_NORM_TOL, (name, worst_norm)
    assert np.median(norms) <= GRAD_NORM_MEDIAN_TOL, (name, np.median(norms))


def _port_grads(model):
    return {n: (torch.zeros_like(p) if p.grad is None else p.grad).numpy().copy()
            for n, p in model.named_parameters()}


# --- DETR ------------------------------------------------------------------------

def _detr_gt():
    boxes = np.array([[[0.4, 0.5, 0.35, 0.4], [0.7, 0.3, 0.2, 0.3], [0.1, 0.1, 0.1, 0.1]],
                      [[0.3, 0.6, 0.3, 0.5], [0.5, 0.5, 0.9, 0.9], [0.6, 0.2, 0.2, 0.2]]],
                     np.float32)
    labels = np.array([[7, 0, 3], [49, 3, 3]], np.int64)
    valid = np.array([[True, True, False], [True, True, True]])
    return boxes, labels, valid


@pytest.fixture(scope="module")
def detr():
    images = np.random.default_rng(0).uniform(-1, 1, (2, *CANVAS, 3)).astype(np.float32)
    sizes = np.array([[64.0, 96.0], [50.0, 80.0]], np.float32)
    boxes, labels, valid = _detr_gt()
    kw = dict(num_classes=80, num_layers=2, num_queries=10)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(JD.DETR(**kw).init)(
        jax.random.PRNGKey(0), jnp.asarray(images), jnp.asarray(sizes)))
    extra = {k: v for k, v in variables.items() if k != "params"}
    jmodels = {k: JD.DETR(dtype=jdt, **kw) for k, (jdt, _) in DTYPES.items()}
    jraw = jax.jit(jmodels["bfloat16"].apply, static_argnames="method")
    lg, bx = jraw(variables, jnp.asarray(images), method=JD.DETR.raw)
    assign = JD.detr_assignments(lg, bx, boxes, labels, valid)
    out = dict(port={}, jax={}, post={}, jax_post={}, loss={}, jax_loss={}, grads={},
               jax_grads={})
    for k, (jdt, tdt) in DTYPES.items():
        model = jmodels[k]

        def fn(p, model=model):
            lg, bx = model.apply({"params": p, **extra}, jnp.asarray(images), method=JD.DETR.raw)
            losses = JD.detr_set_loss(lg, bx, jnp.asarray(assign), boxes, labels, valid)
            post = model.apply({"params": p, **extra}, jnp.asarray(images), jnp.asarray(sizes))
            return sum(losses.values()), (lg, bx, post)

        (loss, (lg, bx, post)), grads = jax.jit(jax.value_and_grad(fn, has_aux=True))(
            variables["params"])
        out["jax"][k], out["jax_post"][k], out["jax_loss"][k] = (lg, bx), post, float(loss)
        out["jax_grads"][k] = {n: v.numpy() for n, v in detr_state_dict(
            {"params": jax.tree_util.tree_map(np.asarray, grads)}).items()}
        port = PD.DETR(dtype=tdt, device="cpu", **kw)
        port.load_state_dict(detr_state_dict(variables), strict=True)
        lg, bx = port.raw(torch.from_numpy(images))
        loss = sum(PD.detr_set_loss(lg, bx, torch.from_numpy(assign), torch.from_numpy(boxes),
                                    torch.from_numpy(labels), torch.from_numpy(valid)).values())
        loss.backward()
        out["port"][k], out["loss"][k] = (lg.detach(), bx.detach()), loss.item()
        out["grads"][k] = _port_grads(port)
        out["post"][k] = port(torch.from_numpy(images), torch.from_numpy(sizes))
    return out


@pytest.mark.parametrize("i,name", [(0, "logits"), (1, "boxes")])
def test_detr_forward(detr, i, name):
    _held(f"detr {name}", {k: v[i].numpy() for k, v in detr["port"].items()},
          {k: np.asarray(v[i]) for k, v in detr["jax"].items()})


def test_detr_postprocessed(detr):
    for field in ("boxes", "scores"):
        _held(f"detr post {field}", {k: getattr(v, field).numpy() for k, v in detr["post"].items()},
              {k: np.asarray(getattr(v, field)) for k, v in detr["jax_post"].items()})
    # Labels: equal wherever JAX's two best classes are further apart than
    # the scores may move.
    got, want = detr["post"]["bfloat16"], detr["jax_post"]["bfloat16"]
    probs = np.asarray(jax.nn.softmax(detr["jax"]["bfloat16"][0], -1)[..., :-1])
    top2 = np.sort(probs, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * TOL["detr post scores"] * probs.max()
    assert clear.mean() > 0.5, clear.mean()
    np.testing.assert_array_equal(got.labels.numpy()[clear], np.asarray(want.labels)[clear])


def test_detr_set_loss_and_gradients(detr):
    _held("detr set loss", detr["loss"], detr["jax_loss"])
    _grads_held("detr", detr["grads"], detr["jax_grads"])


# --- which tensors are bfloat16 ------------------------------------------------------

def _port_dtypes(model, names, run):
    """Run ``run(model)`` with hooks on the named submodules: name -> the
    dtypes of the tensors it returns, ``name:in`` -> of those it is given."""
    seen, hooks, mods = {}, [], dict(model.named_modules())

    def tensors(x):
        x = x if isinstance(x, (tuple, list)) else (x,)
        return [t.dtype for t in x if torch.is_tensor(t)]

    for n in names:
        hooks.append(mods[n].register_forward_pre_hook(
            lambda m, args, n=n: seen.__setitem__(n + ":in", tensors(args))))
        hooks.append(mods[n].register_forward_hook(
            lambda m, args, out, n=n: seen.__setitem__(n, tensors(out))))
    try:
        with torch.no_grad():
            seen["output"] = tensors(run(model))
    finally:
        for h in hooks:
            h.remove()
    return seen


def _jax_dtypes(model, *args, **kwargs):
    """Module path -> the dtypes each flax module's ``__call__`` returns, and
    ``output`` -> those of the whole call (traced only, never run)."""
    def fn(*a):
        variables = model.init(jax.random.PRNGKey(0), *a, **kwargs)
        return model.apply(variables, *a, capture_intermediates=True, **kwargs)

    out, state = jax.eval_shape(fn, *args)
    seen = {"output": [t.dtype for t in jax.tree_util.tree_leaves(out)]}

    def walk(tree, path):
        for k, v in tree.items():
            if k == "__call__":
                seen[path] = [t.dtype for t in jax.tree_util.tree_leaves(v)]
            elif isinstance(v, dict):
                walk(v, f"{path}/{k}" if path else k)

    walk(state["intermediates"], "")
    return seen


BF16, F32 = torch.bfloat16, torch.float32
JBF16, JF32 = jnp.dtype(jnp.bfloat16), jnp.dtype(jnp.float32)


def test_detr_transformer_runs_in_float32():
    images = np.zeros((1, *CANVAS, 3), np.float32)
    kw = dict(num_classes=80, num_layers=2, num_queries=10)
    port = _port_dtypes(PD.DETR(dtype=BF16, device="cpu", **kw),
                        ["body", "input_proj", "encoder.0", "encoder.0.self_attn", "decoder.1"],
                        lambda m: m.raw(torch.from_numpy(images)))
    assert port["body"] == [BF16] * 4 and port["input_proj"] == [BF16]
    assert port["encoder.0:in"] == [F32, F32]  # the features, cast once, and the positions
    assert port["encoder.0.self_attn"] == port["encoder.0"] == port["decoder.1"] == [F32]
    assert port["output"] == [F32, F32]
    jx = _jax_dtypes(JD.DETR(dtype=jnp.bfloat16, **kw), jnp.asarray(images),
                     method=JD.DETR.raw)
    assert jx["body"] == [JBF16] * 4 and jx["input_proj"] == [JBF16]
    assert jx["enc0/self_attn"] == jx["enc0"] == jx["dec1"] == [JF32]
    assert jx["output"] == [JF32, JF32]


# --- the float32 default -----------------------------------------------------------------

STOCK = {layers.Conv2d: nn.Conv2d.forward, layers.Linear: nn.Linear.forward}


def test_float32_default_is_torch_stock_layers():
    """Before DETR took ``dtype`` its ResNet-50 and ``input_proj`` were the
    port's ``Conv2d`` at float32: at the default, every output equals bit for
    bit a run in which each such layer computes with torch's stock
    ``forward``: its casts to ``dtype`` do nothing in float32."""
    images = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (2, *CANVAS, 3))
                              .astype(np.float32))
    model = PD.DETR(num_classes=80, num_layers=2, num_queries=10, device="cpu")
    with torch.no_grad():
        got = model.raw(images)
    swapped = 0
    for m in model.modules():
        if type(m) in STOCK:
            m.forward = types.MethodType(STOCK[type(m)], m)
            swapped += 1
    with torch.no_grad():
        want = model.raw(images)
    assert swapped > 50 and len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)
