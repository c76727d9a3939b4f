"""The port's training slice held against the JAX package, on the CPU.

1. ``roi_align_adjoint`` against ``_roi_backward`` and against ``jax.grad`` of
   ``roi_align_exact(..., interpret=True)`` on the edge, extreme, overflow
   and degenerate boxes of ``test_pallas_roi_align.py``; rtol 1e-3 /
   atol 1e-4 (the JAX suite's tolerance for this gradient).
2. Autograd through the port's CPU RoIAlign path against the same.
3. One fp32 train step of the full-width SCG (64x96, batch 2) against the
   JAX ``build_train_step`` step with the same weights, batch and Gumbel
   noise: losses within rtol 1e-5, labels and TransH samples equal, every
   gradient within ``1e-3 * max|g_jax|``, compared by name through
   ``to_state_dict``; the stem and ``layer1`` get no gradient.
4. Twelve port train steps on one batch drive the losses down as far as
   ``tests/test_training_learns.py`` asks of the JAX step.

The JAX train step is compiled once per ``feedback`` value (a module-scoped
fixture: xdist runs a file on one worker).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as graft
from skghoi_tpu.models import SpatiallyConditionedGraph as JaxSCG
from skghoi_tpu.models.graph_head import GraphHead as JaxGraphHead
from skghoi_tpu.ops.pallas_roi_align import _axis_weights, _roi_backward, roi_align_exact
from skghoi_tpu.parallel.train_step import build_train_step as jax_build_train_step
from skghoi_torch.data.structures import HOIBatch, HOITargets
from skghoi_torch.entry import build_model, make_batch, verb_mask
from skghoi_torch.models.graph_head import GraphHead
from skghoi_torch.models.resnet import ResNet50
from skghoi_torch.ops.roi_align import level_axis_weights, roi_align_adjoint
from skghoi_torch.ops.roi_align_cuda import RoIAlignFunction, roi_align_auto, roi_align_cuda
from skghoi_torch.parallel.train_step import build_train_step
from skghoi_torch.train.optimizer import build_optimizer
from skghoi_torch.weights import to_state_dict
from test_torch_port_roi_align import fixture

torch.set_num_threads(2)

CANVAS = (64, 96)
# The weights' seed.  Float32 rounding moves a ReLU input that lies within
# ~1e-6 of zero to either side, and the gradient through that one unit then
# differs by its whole value (in JAX as in the port: each disagrees with a
# float64 forward somewhere).  At this size that happens about once a step:
# of PRNGKey(0..9), keys 0, 1, 2, 4, 7, 8, 9 flip a unit in the backbone or
# the MBF heads (PRNGKey(0): layer2.0, 5.2e-8 in the port, -2.1e-7 in
# float64), and 3, 5, 6 flip none that matters.  This is the cleanest.
INIT_KEY = 6
ROI_TOL = dict(rtol=1e-3, atol=1e-4)
FIXTURES = ["random", "edge", "extreme", "overflow"]


def _cotangent(boxes, c, seed=3):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(*boxes.shape[:2], 7, 7, c)).astype(np.float32)


def _jax_exact_grad(maps, boxes, g):
    def loss(f):
        return jnp.sum(roi_align_exact(f, jnp.asarray(boxes), interpret=True) * g)

    return jax.grad(loss)(tuple(map(jnp.asarray, maps)))


# --- 1. the plain adjoint ---------------------------------------------------

@pytest.mark.parametrize("size", [7, 26, 84])
def test_level_axis_weights_match_jax(size):
    rng = np.random.default_rng(size)
    start = rng.uniform(-3.0, size + 2.0, 40).astype(np.float32)
    length = np.exp(rng.uniform(-1.0, np.log(2.0 * size), 40)).astype(np.float32)
    start[:3], length[:3] = [-1.5, size - 0.5, 0.0], [0.5, 3.0, size]  # edges, clamped length
    length = np.maximum(length, 1.0)
    want = jax.vmap(lambda s, ln: _axis_weights(s, ln, jnp.zeros((), jnp.int32), size, 7, 2, size))(
        jnp.asarray(start), jnp.asarray(length))
    got = level_axis_weights(torch.from_numpy(start), torch.from_numpy(length), size, size + 5)
    assert got.shape == (40, 7, size + 5) and not got[..., size:].any()
    np.testing.assert_allclose(got[..., :size].numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", FIXTURES)
def test_adjoint_matches_jax(name):
    maps, boxes = fixture(name)
    g = _cotangent(boxes, maps[0].shape[-1])
    got = roi_align_adjoint([m.shape for m in maps], torch.float32, torch.from_numpy(boxes),
                            torch.from_numpy(g))
    want_bwd = _roi_backward(tuple(map(jnp.asarray, maps)), jnp.asarray(boxes), jnp.asarray(g))
    want_grad = _jax_exact_grad(maps, boxes, g)
    for l, (a, b, c) in enumerate(zip(got, want_bwd, want_grad)):
        assert a.dtype == torch.float32 and a.shape == maps[l].shape and a.is_contiguous()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **ROI_TOL, err_msg=f"level {l}")
        np.testing.assert_allclose(a.numpy(), np.asarray(c), **ROI_TOL, err_msg=f"level {l}")
    assert any(a.abs().max() > 0 for a in got)


def test_adjoint_casts_to_map_dtype_and_ignores_other_levels():
    maps, boxes = fixture("edge")
    g = torch.from_numpy(_cotangent(boxes, maps[0].shape[-1]))
    shapes = [m.shape for m in maps]
    f32 = roi_align_adjoint(shapes, torch.float32, torch.from_numpy(boxes), g)
    bf16 = roi_align_adjoint(shapes, torch.bfloat16, torch.from_numpy(boxes), g.bfloat16())
    for a, b in zip(f32, bf16):
        assert b.dtype == torch.bfloat16
        bound = 2.0 ** -7 * (a.abs() + a.abs().max())
        assert ((b.float() - a).abs() <= bound).all()
    # A box with no cotangent contributes nothing: zero cotangent, zero gradient.
    zero = roi_align_adjoint(shapes, torch.float32, torch.from_numpy(boxes), torch.zeros_like(g))
    assert not any(z.any() for z in zero)


# --- 2. autograd through the port's CPU path --------------------------------

@pytest.mark.parametrize("name", FIXTURES)
def test_cpu_autograd_matches_jax(name):
    maps, boxes = fixture(name)
    g = _cotangent(boxes, maps[0].shape[-1])
    tmaps = [torch.from_numpy(m).requires_grad_(True) for m in maps]
    (roi_align_auto(tmaps, torch.from_numpy(boxes)) * torch.from_numpy(g)).sum().backward()
    want = _jax_exact_grad(maps, boxes, g)
    adjoint = roi_align_adjoint([m.shape for m in maps], torch.float32, torch.from_numpy(boxes),
                                torch.from_numpy(g))
    for l, (t, w, a) in enumerate(zip(tmaps, want, adjoint)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **ROI_TOL, err_msg=f"level {l}")
        np.testing.assert_allclose(t.grad.numpy(), a.numpy(), **ROI_TOL, err_msg=f"level {l}")


def test_kernel_called_directly_refuses_grad():
    maps, boxes = fixture("edge")
    tmaps = [torch.from_numpy(m).requires_grad_(True) for m in maps]
    before = roi_align_cuda.launches, RoIAlignFunction.backward_calls
    with pytest.raises(ValueError, match="RoIAlignFunction"):
        roi_align_cuda(tmaps, torch.from_numpy(boxes))
    assert (roi_align_cuda.launches, RoIAlignFunction.backward_calls) == before


@pytest.mark.cuda
def test_function_on_card_matches_plain_autograd():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    from skghoi_torch.ops.roi_align import multiscale_roi_align

    maps, boxes = fixture("overflow")
    g = torch.from_numpy(_cotangent(boxes, maps[0].shape[-1])).cuda()
    b = torch.from_numpy(boxes).cuda()
    grads = []
    for fn in (lambda m: RoIAlignFunction.apply(b, *m), lambda m: multiscale_roi_align(m, b)):
        tm = [torch.from_numpy(m).cuda().requires_grad_(True) for m in maps]
        (fn(tm) * g).sum().backward()
        grads.append([t.grad for t in tm])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, **ROI_TOL)


# --- 3. one train step against JAX -------------------------------------------

def _gradient_capture():
    """An optax transformation whose state after ``update`` is the gradient
    itself (updates are zero): the JAX step then returns its gradients
    exactly, through its own value_and_grad."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree_util.tree_map(jnp.zeros_like, grads), grads),
    )


@pytest.fixture(scope="module")
def jax_variables():
    batch = graft._make_batch(2, CANVAS, with_targets=True)
    ovm = graft._verb_mask()
    variables = jax.jit(lambda r, b: JaxSCG().init(r, b, ovm, training=False))(
        jax.random.PRNGKey(INIT_KEY), batch)
    return batch, ovm, jax.tree_util.tree_map(np.asarray, variables)


@pytest.fixture(scope="module", params=[False, True], ids=["fixed_point", "feedback"])
def step_pair(request, jax_variables):
    """(JAX step results, port step results, port model) for one ``feedback``."""
    feedback = request.param
    batch, ovm, variables = jax_variables
    params = variables["params"]
    extra = {k: v for k, v in variables.items() if k != "params"}
    tx = _gradient_capture()
    step = jax_build_train_step(JaxSCG(feedback=feedback), tx, ovm, donate=False)
    rng = jax.random.PRNGKey(5)
    _, grads, total, losses, out = step(params, extra, tx.init(params), batch, rng)
    gumbel = np.array(jax.random.gumbel(rng, (2, 15 * 30 * 117)))
    want = dict(total=float(total), losses={k: float(v) for k, v in losses.items()},
                labels=np.asarray(out.labels), unary_labels=np.asarray(out.unary_labels),
                dropped=float(out.metrics["transh_pos_dropped"]),
                grads={k: v.numpy() for k, v in to_state_dict({"params": grads}).items()})

    model = build_model(device="cpu", feedback=feedback)
    model.load_state_dict(to_state_dict(variables), strict=True)
    port_step = build_train_step(model, build_optimizer(model), verb_mask(device="cpu"))
    total, losses, out, applied = port_step(make_batch(2, CANVAS, with_targets=True, device="cpu"),
                                            gumbel=torch.from_numpy(gumbel))
    got = dict(total=float(total), losses={k: float(v) for k, v in losses.items()},
               labels=out.labels.numpy(), unary_labels=out.unary_labels.numpy(),
               dropped=float(out.metrics["transh_pos_dropped"]), applied=applied)
    return want, got, model


def test_step_losses_match(step_pair):
    want, got, _ = step_pair
    assert got["applied"]
    assert set(got["losses"]) == set(want["losses"])
    for k, v in want["losses"].items():
        assert v > 0, f"{k} is 0: the comparison would be vacuous"
        np.testing.assert_allclose(got["losses"][k], v, rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["total"], want["total"], rtol=1e-5)


def test_step_labels_match(step_pair):
    want, got, _ = step_pair
    assert want["labels"].sum() > 0, "no positive pair: the comparison would be vacuous"
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_array_equal(got["unary_labels"], want["unary_labels"])
    assert got["dropped"] == want["dropped"]


def test_step_gradients_match(step_pair):
    want, _, model = step_pair
    jgrads = want["grads"]
    trained = frozen = 0
    for name, p in model.named_parameters():
        g_jax = jgrads[name]
        if not p.requires_grad:
            assert p.grad is None and not g_jax.any(), name
            frozen += 1
            continue
        # The adjacency bias shifts every logit of both softmaxes alike, so
        # its exact gradient is 0 and both sides hold rounding noise: it is
        # held to the adjacency weight's scale.
        scale_name = name.replace("adjacency.bias", "adjacency.weight")
        scale = np.abs(jgrads[scale_name]).max()
        np.testing.assert_allclose(p.grad.numpy(), g_jax, rtol=0, atol=1e-3 * scale, err_msg=name)
        trained += 1
    assert frozen == len(list(model.detector.backbone.conv1.parameters())) + len(
        list(model.detector.backbone.layer1.parameters()))
    assert trained > 100


# --- the backbone's training knobs ---------------------------------------------

@pytest.mark.parametrize("frozen", [-1, 0, 1, 3])
def test_frozen_stages_freeze_the_prefix(frozen):
    torch.manual_seed(0)
    net = ResNet50(stage_sizes=(1, 1, 1, 1), frozen_stages=frozen)
    sum(o.float().sum() for o in net(torch.randn(1, 3, 64, 64))).backward()
    for name, p in net.named_parameters():
        stage = 0 if name.startswith("conv1.") else int(name[5])
        assert p.requires_grad == (stage > frozen), name
        assert (p.grad is not None) == p.requires_grad, name
    assert all(not b.requires_grad for b in net.buffers())  # frozen BN: buffers only


def test_remat_stages_give_the_same_gradients():
    torch.manual_seed(0)
    plain = ResNet50(stage_sizes=(2, 2, 2, 2), frozen_stages=1)
    remat = ResNet50(stage_sizes=(2, 2, 2, 2), frozen_stages=1, remat_stages=2)
    remat.load_state_dict(plain.state_dict())
    x = torch.randn(2, 3, 64, 96)
    for net in (plain, remat):
        sum((o * o).sum() for o in net(x)).backward()
    for (name, a), b in zip(plain.named_parameters(), remat.parameters()):
        if a.requires_grad:
            torch.testing.assert_close(b.grad, a.grad, rtol=1e-5, atol=1e-6, msg=name)


# --- the TransH sampler's order ----------------------------------------------

def test_transh_sampler_matches_jax_tie_order():
    rng = np.random.default_rng(4)
    b, h, n, k = 2, 3, 5, 7
    scores = rng.normal(size=(b, h, n, k)).astype(np.float32)
    labels = (rng.uniform(size=(b, h, n, k)) < 0.3).astype(np.float32)
    labels[1] = 0.0  # an image with no positive
    valid = rng.uniform(size=(b, h, n)) < 0.8
    key = jax.random.PRNGKey(9)
    gumbel = np.array(jax.random.gumbel(key, (b, h * n * k)))

    jhead = JaxGraphHead(max_transh_pairs=16)
    want = jhead._sample_transh_pairs(key, jnp.asarray(scores), jnp.asarray(labels),
                                      jnp.asarray(valid))
    head = GraphHead(out_channels=8, node_encoding_size=16, representation_size=16)
    head.max_transh_pairs = 16
    got = head._sample_transh_pairs(torch.from_numpy(gumbel), torch.from_numpy(scores),
                                    torch.from_numpy(labels), torch.from_numpy(valid))
    for name, g, w in zip(("pos", "neg", "mask", "dropped"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert got[2][0].any() and not got[2][1].any()


# --- 4. the port's step learns -------------------------------------------------

def _learn_batch(rng, b=2, m=8, g=2, canvas=CANVAS):
    """``tests/test_training_learns.py::_batch`` in torch: GT pairs sit
    exactly on detection boxes, so association fires."""
    def boxes(k):
        xy = rng.uniform(0, 30, (b, k, 2))
        wh = rng.uniform(10, 28, (b, k, 2))
        return torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(np.float32))

    det = boxes(m)
    labels = torch.from_numpy(rng.integers(0, 80, (b, m)))
    labels[:, :3] = 49
    size = torch.tensor([list(canvas)] * b, dtype=torch.float32)
    return HOIBatch(
        images=torch.from_numpy(rng.uniform(0, 1, (b, *canvas, 3)).astype(np.float32)),
        image_sizes=size, original_sizes=size, det_boxes=det, det_labels=labels,
        det_scores=torch.from_numpy(rng.uniform(0.5, 1, (b, m)).astype(np.float32)),
        det_valid=torch.ones((b, m), dtype=torch.bool),
        targets=HOITargets(det[:, :g], det[:, 3:3 + g], labels[:, 3:3 + g].clone(),
                           torch.from_numpy(rng.integers(0, 117, (b, g))),
                           torch.ones((b, g), dtype=torch.bool)),
    )


def test_train_steps_reduce_losses():
    batch = _learn_batch(np.random.default_rng(0))
    model = build_model(device="cpu")
    opt = build_optimizer(model, learning_rate=3e-3, steps_per_epoch=1000)
    step = build_train_step(model, opt, torch.ones(80, 117))
    totals, hoi = [], []
    for i in range(12):
        total, losses, _, applied = step(batch, generator=torch.Generator().manual_seed(100 + i))
        assert applied
        totals.append(float(total))
        hoi.append(float(losses["hoi_loss"]))
    assert np.isfinite(totals).all()
    assert totals[-1] < 0.7 * totals[0], (totals[0], totals[-1])
    assert hoi[-1] < 0.8 * hoi[0], (hoi[0], hoi[-1])
