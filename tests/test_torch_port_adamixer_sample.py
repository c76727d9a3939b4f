"""AdaMixer's 3D sampling: the route to the card's kernels and the eager
route they are held to, on the CPU.

- the eager route's gradients (autograd through ``sample_groups``, the
  reference of the card's adjoint kernel) against ``jax.vjp`` of the JAX
  package's ``sample_3d`` over each group's channel slice: points inside,
  past every border (clamped taps), on exact pixel edges; 1 and 4 groups;
  landscape and portrait levels; and ``torch.autograd.gradcheck`` of the
  eager route in float64;
- the dispatch: CPU tensors of every dtype and layout take the eager
  route, and ``refusal`` names float16 and bfloat16 for their dtype;
- the kernels' wrapper refuses CPU tensors and builds nothing; its C entry
  points and argument lists match the source;
- by AST, through the module's own helpers: ``_sample_grouped`` sends every
  CUDA tensor to ``SampleFunction`` and only other devices to the gathers,
  and ``SampleFunction``'s backward reaches the adjoint kernel's launch and
  no ``gather`` or ``scatter_add``, with the twin that shows the scan
  catches them.

On a card only (marker ``cuda``; run without the tests' conftest): the
kernels at the training cell's shapes, the forward ``torch.equal`` to the
eager route and the adjoint within ``chip_smoke.SAMPLE_ADJOINT_TOL`` of
autograd through it; one launch each way a decoder stage; strided and
offset inputs reach the kernels; bfloat16 and channels that fill no 16-byte
vector raise.  ``chip_smoke.phase_adamixer_sample`` times them.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from skghoi_torch.detect import adamixer as A
from skghoi_torch.ops import adamixer_sample_cuda as S

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
SHAPES = {"landscape": (64, 96), "portrait": (96, 64)}  # image (H, W); levels at strides 4..32
JAX_GRAD_TOL = 1e-5  # float32, relative to each gradient's largest: the scatter-adds' order differs


def _levels(image_hw, groups, c, batch, rng, dtype=torch.float64):
    """``group_pyramid``'s layout: per level ``(feat [B, G, H*W, c], H, W)``."""
    out = []
    for stride in A.LEVEL_STRIDES:
        h, w = image_hw[0] // int(stride), image_hw[1] // int(stride)
        feat = torch.from_numpy(rng.standard_normal((batch, groups, h * w, c))).to(dtype)
        out.append((feat, h, w))
    return out


def _points(kind, image_hw, groups, m, batch, rng, dtype=torch.float64):
    """``[B, G, M, 3]`` points (x, y image pixels, z log2-scale)."""
    ih, iw = image_hw
    shape = (batch, groups, m)
    if kind == "inside":
        x, y = rng.uniform(0, iw, shape), rng.uniform(0, ih, shape)
    elif kind == "past_borders":  # left, right, above, below and the corners beyond them
        x = rng.choice([-45.0, -3.0, iw + 2.0, iw + 50.0, iw / 2], shape) + rng.uniform(0, 1, shape)
        y = rng.choice([-37.0, -1.5, ih + 1.0, ih + 41.0, ih / 2], shape) + rng.uniform(0, 1, shape)
    else:  # on pixel edges: x / stride - 0.5 a whole number on level 0 or level 3
        x = np.where(rng.uniform(size=shape) < 0.5, 4.0 * rng.integers(0, iw // 4, shape) + 2.0,
                     32.0 * rng.integers(-1, iw // 32 + 1, shape) + 16.0)
        y = np.where(rng.uniform(size=shape) < 0.5, 4.0 * rng.integers(0, ih // 4, shape) + 2.0,
                     32.0 * rng.integers(-1, ih // 32 + 1, shape) + 16.0)
    z = rng.uniform(1.0, 6.5, shape)
    return torch.from_numpy(np.stack([x, y, z], -1)).to(dtype)


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-300)).item()


def _jax_grouped(pyramid, points):
    """The JAX package's stage sampling: ``sample_3d`` over group ``g``'s
    channel slice for each group, ``points [B, N, G, P, 3]``."""
    import jax.numpy as jnp
    from skghoi_tpu.detect import adamixer as J

    groups, cg = points.shape[2], pyramid[0].shape[-1] // points.shape[2]
    return jnp.concatenate([J.sample_3d([f[..., gi * cg:(gi + 1) * cg] for f in pyramid],
                                        points[:, :, gi:gi + 1]) for gi in range(groups)], 2)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("kind", ["inside", "past_borders", "pixel_edges"])
def test_the_eager_routes_gradients_equal_jax(kind, groups, shape):
    """Autograd through the eager route, which the card's adjoint kernel is
    held to, against ``jax.vjp`` of the JAX package's sampling in float32:
    the points' (z through the level weights) and every level's gradient
    within ``JAX_GRAD_TOL`` of its largest."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(len(kind) * 10 + groups)
    b, n, p, c = 2, 3, 8, 4 * groups
    ih, iw = SHAPES[shape]
    pyramid = [rng.standard_normal((b, ih // int(s), iw // int(s), c)).astype(np.float32)
               for s in A.LEVEL_STRIDES]
    points = _points(kind, SHAPES[shape], groups, n * p, b, rng, torch.float32)
    points = points.view(b, groups, n, p, 3).permute(0, 2, 1, 3, 4).contiguous().numpy()
    grad_out = rng.standard_normal((b, n, groups, p, c // groups)).astype(np.float32)

    pyr = [torch.from_numpy(f).requires_grad_(True) for f in pyramid]
    pts = torch.from_numpy(points).requires_grad_(True)
    out = A.sample_groups(A.group_pyramid(pyr, groups), pts)
    got = torch.autograd.grad(out, [pts, *pyr], torch.from_numpy(grad_out))

    want_out, vjp = jax.vjp(_jax_grouped, [jnp.asarray(f) for f in pyramid], jnp.asarray(points))
    want_pyr, want_pts = vjp(jnp.asarray(grad_out))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=1e-5, atol=1e-5)
    names = ["points", "level0", "level1", "level2", "level3"]
    for name, g, w in zip(names, got, [want_pts, *want_pyr]):
        w = torch.from_numpy(np.array(w))
        assert g.shape == w.shape and w.abs().max() > 0, name
        assert _rel(g, w) <= JAX_GRAD_TOL, (name, _rel(g, w))


@pytest.mark.parametrize("kind", ["inside", "past_borders"])
def test_gradcheck_of_the_eager_route(kind):
    """The eager route's autograd gradient, the card's reference, is the
    true derivative (random points sit off the pixel edges, where bilinear
    sampling's slope jumps)."""
    rng = np.random.default_rng(11)
    levels = _levels((32, 64), 2, 4, 1, rng)
    hw = [(h, w) for _, h, w in levels]
    points = _points(kind, (32, 64), 2, 5, 1, rng).requires_grad_(True)
    feats = [f.requires_grad_(True) for f, _, _ in levels]

    def fn(p, *f):
        return A._sample_grouped([(fi, h, w) for fi, (h, w) in zip(f, hw)], p, 2.0)

    assert torch.autograd.gradcheck(fn, (points, *feats), eps=1e-6, atol=1e-8)


@pytest.mark.parametrize("dtype", ["float32", "float64", "float16", "bfloat16"])
def test_the_dispatch_takes_the_eager_route(dtype, monkeypatch):
    """On the CPU every dtype samples eagerly (the Function is never
    applied); the wrapper would refuse float16 and bfloat16 for their dtype
    before it asks for the device."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(3)
    levels = _levels(SHAPES["portrait"], 4, 8, 1, rng, dt)
    points = _points("inside", SHAPES["portrait"], 4, 16, 1, rng, dt)
    wts = torch.full((1, 4, 16, 4), 0.25, dtype=dt)
    feats = [f for f, _, _ in levels]
    reason = S.refusal(feats, points, wts)
    assert ("dtype" if dt in (torch.float16, torch.bfloat16) else "need CUDA tensors") in reason

    def refuse(*args):
        raise AssertionError("SampleFunction applied on the eager route")

    monkeypatch.setattr(A.SampleFunction, "apply", refuse)
    out = A._sample_grouped(levels, points, 2.0)
    logs = A._level_logs(points.device, points.dtype)
    wts = torch.softmax(-((points[..., 2:] - logs) ** 2) / 2.0, dim=-1)
    assert out.dtype == dt and torch.equal(
        out, A._sample_levels(levels, points, wts))


@pytest.mark.parametrize("case", ["strided_points", "offset_level"])
def test_the_cpu_route_takes_any_layout(case):
    """On the CPU a strided or offset input samples as its contiguous copy
    does, bit for bit (the card copies such inputs before its kernels)."""
    rng = np.random.default_rng(4)
    levels = _levels(SHAPES["landscape"], 4, 8, 1, rng, torch.float32)
    points = _points("past_borders", SHAPES["landscape"], 4, 16, 1, rng, torch.float32)
    want = A._sample_grouped(levels, points, 2.0)
    if case == "strided_points":
        points = torch.cat([points, points], -1)[..., :3]
        assert not points.is_contiguous()
    else:
        f, h, w = levels[1]
        levels[1] = (torch.cat([f.new_zeros(1), f.flatten()])[1:].view(f.shape), h, w)
        assert levels[1][0].data_ptr() % 16
    assert torch.equal(A._sample_grouped(levels, points, 2.0), want)


def test_level_logs_are_built_once_a_device_and_dtype():
    first = A._level_logs(torch.device("cpu"), torch.float32)
    assert A._level_logs(torch.device("cpu"), torch.float32) is first
    assert first.tolist() == list(A.LEVEL_LOGS)
    assert A._level_logs(torch.device("cpu"), torch.float64).dtype == torch.float64


def test_the_kernel_wrapper_refuses_cpu_tensors():
    kernel = S.SampleKernel()
    rng = np.random.default_rng(0)
    levels = _levels(SHAPES["landscape"], 4, 8, 1, rng, torch.float32)
    feats, hw = [f for f, _, _ in levels], [(h, w) for _, h, w in levels]
    points = _points("inside", SHAPES["landscape"], 4, 16, 1, rng, torch.float32)
    wts = torch.full((1, 4, 16, 4), 0.25)
    with pytest.raises(ValueError, match="need CUDA tensors"):
        kernel(feats, hw, A.INV_STRIDES, points, wts)
    with pytest.raises(ValueError, match="need CUDA tensors"):
        kernel.adjoint(torch.zeros(1, 4, 16, 8), feats, hw, A.INV_STRIDES, points, wts)
    assert (kernel.launches, kernel.backward_calls, kernel._lib) == (0, 0, None)


def test_entry_points_and_argument_lists_match_the_source():
    defined = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', S.SOURCE.read_text()))
    assert set(S.ENTRY_POINTS) == set(defined)
    kinds = {S.ctypes.c_void_p: "pointer", S.ctypes.c_int: "int", S.ctypes.c_int64: "int64_t"}
    for name, argtypes in (("skghoi_adamixer_sample_fwd", S._FWD_ARGTYPES),
                           ("skghoi_adamixer_sample_bwd", S._BWD_ARGTYPES)):
        params = ["pointer" if "*" in p else p.split()[-2] for p in defined[name].split(",")]
        assert params == [kinds[t] for t in argtypes], name


# --- on the card the backward is the adjoint kernel ------------------------------

PLAIN_ROUTE = {"gather", "scatter_add", "scatter_add_", "index_add", "index_add_",
               "_bilinear_sample", "_sample_levels"}


def _cpu_branch(node):
    """``if <x>.device.type != "cuda":``, the CPU's route."""
    return (isinstance(node, ast.If) and isinstance(node.test, ast.Compare)
            and isinstance(node.test.ops[0], ast.NotEq)
            and ast.unparse(node.test.left).endswith("device.type")
            and ast.unparse(node.test.comparators[0]) in ("'cuda'", '"cuda"'))


def _function(tree, name, cls=None):
    """The module-level function ``name``, or ``cls``'s method ``name``."""
    body = tree.body if cls is None else next(
        c.body for c in tree.body if isinstance(c, ast.ClassDef) and c.name == cls)
    return next(f for f in body if isinstance(f, ast.FunctionDef) and f.name == name)


def _card_calls(tree, name, cls=None):
    """Names of every call reached on the card from function ``name`` (a
    method of ``cls`` if given): the bodies of CPU branches are skipped, and
    calls of the module's own functions and methods are followed (by name)
    into theirs."""
    defs = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            defs[node.name] = node
        elif isinstance(node, ast.ClassDef):
            defs.update({f.name: f for f in node.body if isinstance(f, ast.FunctionDef)})
    reached, todo, seen = set(), [_function(tree, name, cls)], set()
    while todo:
        fn = todo.pop()
        if fn.name in seen:
            continue
        seen.add(fn.name)
        stack = list(fn.body)
        while stack:
            node = stack.pop()
            if _cpu_branch(node):
                stack.extend(node.orelse)
                continue
            if isinstance(node, ast.Call):
                called = node.func.id if isinstance(node.func, ast.Name) else getattr(
                    node.func, "attr", None)
                if called:
                    reached.add(called)
                    if called in defs:
                        todo.append(defs[called])
            stack.extend(ast.iter_child_nodes(node))
    return reached


def _branches(fn):
    """Every ``if`` in ``fn``: a CPU branch or not."""
    return [_cpu_branch(node) for node in ast.walk(fn) if isinstance(node, (ast.If, ast.IfExp))]


ADAMIXER = ROOT / "skghoi_torch" / "detect" / "adamixer.py"


def test_the_cards_backward_reaches_the_adjoint_kernel_and_no_gather():
    tree = ast.parse(ADAMIXER.read_text())
    reached = _card_calls(tree, "backward", "SampleFunction")
    assert "adjoint" in reached
    assert not reached & PLAIN_ROUTE, sorted(reached & PLAIN_ROUTE)
    forward = _card_calls(tree, "forward", "SampleFunction")
    assert "sample_cuda" in forward and not forward & PLAIN_ROUTE, sorted(forward)


def test_every_cuda_tensor_reaches_the_kernels():
    """``_sample_grouped`` has one branch, the CPU's, which alone reaches
    the gathers; on the card it applies ``SampleFunction`` whatever the
    tensors' layout or dtype (the wrapper raises on what it cannot take)."""
    tree = ast.parse(ADAMIXER.read_text())
    fn = _function(tree, "_sample_grouped")
    assert _branches(fn) == [True]
    reached = _card_calls(tree, "_sample_grouped")
    assert "apply" in reached and not reached & PLAIN_ROUTE, sorted(reached)
    assert "_sample_levels" in {getattr(n.func, "id", None) for n in ast.walk(fn)
                                if isinstance(n, ast.Call)}


def test_the_card_rule_sees_what_it_checks():
    """The scan follows a helper's helper on the card's route and catches a
    gather there; a gather in the CPU branch is not the card's; a fallback
    on the card is a branch of its own and reaches the gathers."""
    tree = ast.parse(
        "class SampleFunction:\n"
        "    def backward(ctx, g):\n"
        "        if g.device.type != 'cuda':\n"
        "            return torch.gather(g, 0, g)\n"
        "        return helper(g)\n"
        "def helper(g):\n"
        "    return sample_cuda.inner(g)\n"
        "class K:\n"
        "    def inner(self, g):\n"
        "        return g.scatter_add_(2, g, g)\n")
    assert _card_calls(tree, "backward", "SampleFunction") & PLAIN_ROUTE == {"scatter_add_"}
    cpu_only = ast.parse(
        "class SampleFunction:\n"
        "    def backward(ctx, g):\n"
        "        if g.device.type != 'cuda':\n"
        "            return torch.gather(g, 0, g)\n"
        "        return sample_cuda.adjoint(g)\n")
    assert _card_calls(cpu_only, "backward", "SampleFunction") == {"adjoint"}
    fallback = ast.parse(
        "def _sample_grouped(levels, points, tau):\n"
        "    if points.device.type != 'cuda':\n"
        "        return _sample_levels(levels, points, tau)\n"
        "    if takes(levels, points):\n"
        "        return SampleFunction.apply(points, levels)\n"
        "    return _sample_levels(levels, points, tau)\n")
    fn = _function(fallback, "_sample_grouped")
    assert _branches(fn) == [True, False]
    assert "_sample_levels" in _card_calls(fallback, "_sample_grouped")


# --- on a card only (marker ``cuda``) --------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sampling kernels have no CPU form")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_the_kernels_at_the_training_cells_shapes(dtype):
    """Both canvases at batch 4: the forward ``torch.equal`` to the eager
    route, the adjoint within ``chip_smoke.SAMPLE_ADJOINT_TOL`` of autograd
    through it, each call counted once."""
    _card()
    import chip_smoke

    dt = getattr(torch, dtype)
    before = S.sample_cuda.launches, S.sample_cuda.backward_calls
    for seed, canvas in enumerate((chip_smoke.CANVAS, chip_smoke.PORTRAIT)):
        levels, points, wts = chip_smoke.sample_inputs(canvas, dt, seed)
        feats, hw = [f for f, _, _ in levels], [(h, w) for _, h, w in levels]
        got = S.sample_cuda(feats, hw, A.INV_STRIDES, points, wts)
        assert torch.equal(got, A._sample_levels(levels, points, wts))
        grad_out = torch.randn_like(got)
        kernel = S.sample_cuda.adjoint(grad_out, feats, hw, A.INV_STRIDES, points, wts)
        want = chip_smoke.sample_adjoint_autograd(grad_out, levels, points, wts)
        for a, b in zip([*kernel[:2], *kernel[2]], [*want[:2], *want[2]]):
            assert _rel(a, b) <= chip_smoke.SAMPLE_ADJOINT_TOL[dt], (canvas, _rel(a, b))
    assert (S.sample_cuda.launches - before[0], S.sample_cuda.backward_calls - before[1]) == (2, 2)


@pytest.mark.cuda
def test_one_decoder_step_launches_each_kernel_once_a_stage():
    _card()
    decoder = A.AdaMixerDecoder(num_queries=20, num_stages=3).cuda()
    pyramid = [torch.randn(2, 256 // s, 384 // s, 256, device="cuda", requires_grad=True)
               for s in (4, 8, 16, 32)]
    before = S.sample_cuda.launches, S.sample_cuda.backward_calls
    out = decoder(pyramid, (256.0, 384.0))
    (out.cls_logits.sum() + out.boxes.sum()).backward()
    assert (S.sample_cuda.launches - before[0], S.sample_cuda.backward_calls - before[1]) == (3, 3)
    assert all(torch.isfinite(p.grad).all() for p in pyramid)


def _card_inputs(dt, c, rng):
    levels = [(f.cuda(), h, w) for f, h, w in _levels(SHAPES["landscape"], 4, c, 1, rng, dt)]
    points = _points("past_borders", SHAPES["landscape"], 4, 16, 1, rng, dt).cuda()
    return levels, points


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["strided_points", "offset_level"])
def test_strided_and_offset_inputs_reach_the_kernels(case):
    """A layout the kernels cannot read as it stands is copied into one they
    can, and sampled there: the forward bit for bit the eager route, the
    gradients within ``SAMPLE_ADJOINT_TOL`` of autograd through it."""
    _card()
    import chip_smoke

    rng = np.random.default_rng(2)
    levels, points = _card_inputs(torch.float32, 8, rng)
    if case == "strided_points":
        points = torch.cat([points, points], -1)[..., :3]
    else:  # level 1 starts one float past a 16-byte boundary
        f, h, w = levels[1]
        levels[1] = (torch.cat([f.new_zeros(1), f.flatten()])[1:].view(f.shape), h, w)
    assert S.refusal([f for f, _, _ in levels], points, torch.empty(1, 4, 16, 4, device="cuda"))
    pts = points.detach().requires_grad_(True)
    feats = [f.detach().requires_grad_(True) for f, _, _ in levels]
    before = S.sample_cuda.launches, S.sample_cuda.backward_calls
    out = A._sample_grouped([(f, h, w) for f, (_, h, w) in zip(feats, levels)], pts, 2.0)
    grad_out = torch.randn_like(out)
    got = torch.autograd.grad(out, [pts, *feats], grad_out)
    assert (S.sample_cuda.launches - before[0], S.sample_cuda.backward_calls - before[1]) == (1, 1)
    wts = torch.softmax(-((points[..., 2:] - A._level_logs(points.device, points.dtype)) ** 2)
                        / 2.0, dim=-1)
    assert torch.equal(out, A._sample_levels(levels, points, wts))
    pts = points.detach().requires_grad_(True)
    feats = [f.detach().requires_grad_(True) for f, _, _ in levels]
    eager = A._sample_levels([(f, h, w) for f, (_, h, w) in zip(feats, levels)], pts,
                             torch.softmax(-((pts[..., 2:] - A._level_logs(pts.device, pts.dtype))
                                             ** 2) / 2.0, dim=-1))
    want = torch.autograd.grad(eager, [pts, *feats], grad_out)
    for a, b in zip(got, want):
        assert _rel(a, b) <= chip_smoke.SAMPLE_ADJOINT_TOL[torch.float32], (case, _rel(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bfloat16", "odd_channels"])
def test_what_the_kernels_do_not_take_raises_on_the_card(case):
    """On the card there is no eager fallback: a dtype or a channel count the
    kernels do not take is an error that names it."""
    _card()
    rng = np.random.default_rng(2)
    dt = torch.bfloat16 if case == "bfloat16" else torch.float32
    levels, points = _card_inputs(dt, 6 if case == "odd_channels" else 8, rng)
    match = "dtype torch.bfloat16" if case == "bfloat16" else "16-byte vectors"
    before = S.sample_cuda.launches
    with pytest.raises(ValueError, match=match):
        A._sample_grouped(levels, points, 2.0)
    assert S.sample_cuda.launches == before
