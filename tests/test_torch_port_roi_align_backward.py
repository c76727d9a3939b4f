"""The RoIAlign adjoint held against the JAX package, and its CUDA kernel's
arithmetic, binding and entry points.

1. ``roi_align_adjoint`` (the plain version, batched GEMMs) against the JAX
   package's ``_roi_backward`` and against ``jax.grad`` of its gather path, at
   rtol 1e-3 / atol 1e-4 (the JAX suite's tolerance for this gradient), on
   stress fixtures: C = 136 and 64, B = 1 and N = 1, padding slots only,
   boxes whose samples fall outside ``[-1, size]`` on each side, boxes that
   span a whole level, many boxes on one cell.
2. The adjoint kernel's arithmetic in numpy (:func:`_kernel_adjoint`): the
   tile test, each box's distinct cells and bin weights by the forward's
   ranking rule, the per-cell bin spans, the sum over boxes in index order;
   against ``roi_align_adjoint`` at rtol = atol = 1e-5.
3. The binding: the adjoint's argument checks raise one ValueError that
   names every problem, before anything is built; every C entry point the
   binding loads is defined in ``csrc/roi_align.cu``.
4. On a card only: the kernel against ``roi_align_adjoint`` at
   ``chip_smoke.py`` phase 5's tolerances, and two calls bit for bit.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skghoi_tpu.ops.pallas_roi_align import _roi_backward
from skghoi_tpu.ops.roi_align import multiscale_roi_align as jax_gather
from skghoi_torch.ops import roi_align as plain
from skghoi_torch.ops import roi_align_cuda
from skghoi_torch.ops.roi_align import fpn_level_assignment, roi_align_adjoint
from skghoi_torch.ops.roi_align_cuda import ENTRY_POINTS, SOURCE, RoIAlignKernel
from test_torch_port_roi_align import _kernel_ranks, make_maps

torch.set_num_threads(2)

ROI_TOL = dict(rtol=1e-3, atol=1e-4)
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)  # chip_smoke.FP32_TOL: the kernel against the plain GEMMs
STRIDES = (4, 8, 16, 32)
TILE = 8  # kTile in roi_align.cu

# Samples outside [-1, size] on each side of a 128x192 canvas (P2 32x48
# cells), and boxes straddling each edge, on P2 and P3.
OUTSIDE = [
    [-60.0, 20.0, -10.0, 60.0], [200.0, 20.0, 260.0, 60.0],    # left, right of the map
    [20.0, -70.0, 60.0, -10.0], [20.0, 140.0, 60.0, 200.0],    # above, below
    [-10.0, -10.0, 20.0, 20.0], [170.0, 100.0, 200.0, 135.0],  # across two corners
    [-300.0, 0.0, -100.0, 128.0], [190.0, -5.0, 400.0, 110.0],  # P3, off the left and right
]
# On a 64x96 canvas (P2 16x24 cells): the whole canvas (P2), and boxes that
# cover P4 and P5 and beyond.
WHOLE = [[0.0, 0.0, 96.0, 64.0], [-100.0, -100.0, 300.0, 300.0],
         [-300.0, -300.0, 500.0, 500.0], [0.0, 0.0, 96.0, 64.0]]


def _fixture(name):
    """(maps, boxes) as numpy float32."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name in ("c136", "c64"):
        xy = rng.uniform(-20, 170, (2, 5, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(2, 200, (2, 5, 2))], -1)
        return make_maps(rng, 2, (128, 192), int(name[1:])), boxes.astype(np.float32)
    if name == "b1n1":
        return make_maps(rng, 1, (128, 192), 16), np.asarray([[[30.0, 20.0, 90.0, 70.0]]], np.float32)
    if name == "padding":
        return make_maps(rng, 2, (128, 192), 8), np.zeros((2, 4, 4), np.float32)
    if name == "outside":
        return make_maps(rng, 2, (128, 192), 8), np.asarray([OUTSIDE] * 2, np.float32)
    if name == "whole_level":
        return make_maps(rng, 2, (64, 96), 8), np.asarray([WHOLE] * 2, np.float32)
    if name == "one_cell":
        # 40 boxes an image inside one P2 cell, ten of them equal.
        xy = 40.0 + rng.uniform(0, 1.5, (2, 40, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(0.05, 2.4, (2, 40, 2))], -1)
        boxes[:, 30:] = boxes[:, :1]
        return make_maps(rng, 2, (128, 192), 8), boxes.astype(np.float32)
    raise KeyError(name)


FIXTURES = ["c136", "c64", "b1n1", "padding", "outside", "whole_level", "one_cell"]


def _cotangent(boxes, c, seed=4):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(*boxes.shape[:2], 7, 7, c)).astype(np.float32)


def _plain(maps, boxes, g, dtype=torch.float32):
    return roi_align_adjoint([m.shape for m in maps], dtype, torch.from_numpy(boxes),
                             torch.from_numpy(g))


def test_fixtures_reach_what_they_name():
    levels = {n: fpn_level_assignment(torch.from_numpy(_fixture(n)[1])) for n in FIXTURES}
    assert _fixture("c136")[0][0].shape[-1] == 136 and _fixture("c64")[0][0].shape[-1] == 64
    assert _fixture("b1n1")[1].shape == (1, 1, 4)
    assert sorted(set(levels["whole_level"][0].tolist())) == [0, 2, 3]
    assert sorted(set(levels["outside"][0].tolist())) == [0, 1]
    # every outside box but the two straddling ones has all samples of one axis outside [-1, size]
    maps, boxes = _fixture("outside")
    for n, box in enumerate(boxes[0]):
        l = int(levels["outside"][0, n])
        h, w = maps[l].shape[1:3]
        out = []
        for axis, size in ((0, w), (1, h)):
            start = torch.tensor(box[axis] / STRIDES[l])
            length = (torch.tensor(box[axis + 2] / STRIDES[l]) - start).clamp_min(1.0)
            out.append(bool(plain._sample_axis(start[None], length[None], size, 7, 2)[4].all()))
        assert any(out) == (n not in (4, 5)), n
    assert (np.floor(_fixture("one_cell")[1] / 4.0) == 10).all()  # every corner in P2 cell 10


@pytest.mark.parametrize("name", FIXTURES)
def test_adjoint_matches_jax(name):
    maps, boxes = _fixture(name)
    g = _cotangent(boxes, maps[0].shape[-1])
    got = _plain(maps, boxes, g)
    jmaps = tuple(map(jnp.asarray, maps))
    want_bwd = _roi_backward(jmaps, jnp.asarray(boxes), jnp.asarray(g))

    def loss(fms):
        out = jax.vmap(lambda *a: jax_gather(a[:-1], a[-1]))(*fms, jnp.asarray(boxes))
        return jnp.sum(out * g)

    want_grad = jax.grad(loss)(jmaps)
    for l, (a, b, c) in enumerate(zip(got, want_bwd, want_grad)):
        assert a.dtype == torch.float32 and a.shape == maps[l].shape and a.is_contiguous()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **ROI_TOL, err_msg=f"level {l}")
        np.testing.assert_allclose(a.numpy(), np.asarray(c), **ROI_TOL, err_msg=f"level {l}")
    if name != "padding":
        assert any(a.abs().max() > 0 for a in got)


# --- 2. the kernel's arithmetic ----------------------------------------------

def _axis(box, l, size, is_x):
    """One axis of a box on level l as the kernel sees it: the samples' low
    and high cells and weights (0 outside [-1, size]), the sorted distinct
    cells and each sample's indices in them (the forward's ranking rule)."""
    scale = np.float32(1.0 / STRIDES[l])
    i = 0 if is_x else 1
    start = torch.tensor([np.float32(box[i]) * scale])
    length = (torch.tensor([np.float32(box[i + 2]) * scale]) - start).clamp_min(1.0)
    lo, hi, w_lo, w_hi, oob = (t.reshape(-1).numpy() for t in
                               plain._sample_axis(start, length, size, 7, 2))
    cells, r_lo, r_hi = _kernel_ranks(lo, hi)
    return lo, hi, np.where(oob, 0, w_lo), np.where(oob, 0, w_hi), cells, r_lo, r_hi


def _adjoint_table(w_lo, w_hi, cells, r_lo, r_hi, w_scale):
    """adjoint_axis: weight[d, p] of distinct cell d in bin p, and span[d],
    the first and last bin whose samples touch d."""
    weight = np.zeros((len(cells), 7), np.float32)
    span = []
    for d in range(len(cells)):
        touch = []
        for p in range(7):
            s0, s1 = 2 * p, 2 * p + 1
            weight[d, p] = (np.float32(w_lo[s0] * w_scale if r_lo[s0] == d else 0)
                            + np.float32(w_hi[s0] * w_scale if r_hi[s0] == d else 0)
                            + np.float32(w_lo[s1] * w_scale if r_lo[s1] == d else 0)
                            + np.float32(w_hi[s1] * w_scale if r_hi[s1] == d else 0))
            if d in (r_lo[s0], r_hi[s0], r_lo[s1], r_hi[s1]):
                touch.append(p)
        span.append((touch[0], touch[-1]))
        outside = [p for p in range(7) if not touch[0] <= p <= touch[-1]]
        assert not weight[d, outside].any()  # the span holds every nonzero weight
    return weight, span


def _kernel_adjoint(maps, boxes, g):
    """The adjoint kernel in numpy: for each level's tile of TILE x TILE
    cells, the image's boxes on that level that pass the tile test, in index
    order; each adds, at the tile's cells among its distinct rows and
    columns, sum over bins py in the row's span of A_y * (sum over px in the
    column's span of A_x * g).  float32 throughout."""
    levels = fpn_level_assignment(torch.from_numpy(boxes)).numpy()
    out = [np.zeros(m.shape, np.float32) for m in maps]
    for (b, n), l in np.ndenumerate(levels):
        h, w = maps[l].shape[1:3]
        ys, xs = _axis(boxes[b, n], l, h, False), _axis(boxes[b, n], l, w, True)
        # The tile test: the first sample's low cell to the last sample's high
        # cell bound the distinct cells.
        (y_first, y_last), (x_first, x_last) = (ys[0][0], ys[1][-1]), (xs[0][0], xs[1][-1])
        assert y_first <= ys[4].min() and ys[4].max() <= y_last
        assert x_first <= xs[4].min() and xs[4].max() <= x_last
        wy, span_y = _adjoint_table(*ys[2:], np.float32(0.25))
        wx, span_x = _adjoint_table(*xs[2:], np.float32(1.0))
        for dy, y in enumerate(ys[4]):
            for dx, x in enumerate(xs[4]):
                ty, tx = y // TILE * TILE, x // TILE * TILE
                if not (y_first < ty + TILE and y_last >= ty and x_first < tx + TILE
                        and x_last >= tx):
                    continue  # the kernel's tile would skip the box
                acc = out[l][b, y, x]
                for py in range(span_y[dy][0], span_y[dy][1] + 1):
                    t = np.zeros_like(acc)
                    for px in range(span_x[dx][0], span_x[dx][1] + 1):
                        t += wx[dx, px] * g[b, n, py, px]
                    acc += wy[dy, py] * t
    return out


@pytest.mark.parametrize("name", FIXTURES)
def test_kernel_arithmetic_matches_plain(name):
    maps, boxes = _fixture(name)
    g = _cotangent(boxes, maps[0].shape[-1])
    for l, (a, b) in enumerate(zip(_kernel_adjoint(maps, boxes, g), _plain(maps, boxes, g))):
        np.testing.assert_allclose(a, b.numpy(), **KERNEL_TOL, err_msg=f"level {l}")


# --- 3. the binding ----------------------------------------------------------

def _adjoint_inputs(c=16, bsz=2, n=3):
    rng = np.random.default_rng(9)
    grads = [torch.empty(m.shape) for m in make_maps(rng, bsz, (64, 96), c)]
    boxes = torch.from_numpy(rng.uniform(0, 60, (bsz, n, 4)).astype(np.float32))
    grad_out = torch.from_numpy(rng.normal(size=(bsz, n, 7, 7, c)).astype(np.float32))
    return grads, boxes, fpn_level_assignment(boxes), grad_out


def _bad(kind):
    grads, boxes, levels, grad_out = _adjoint_inputs(c=12 if kind == "channels" else 16)
    if kind == "cotangent_dtype":
        grad_out = grad_out.bfloat16()
    elif kind == "cotangent_layout":
        grad_out = grad_out.transpose(2, 3).contiguous().transpose(2, 3)
    elif kind == "cotangent_shape":
        grad_out = grad_out[:, :, :6]
    elif kind == "alignment":
        grad_out = torch.empty(grad_out.numel() + 1)[1:].view(grad_out.shape).copy_(grad_out)
    elif kind == "levels":
        levels = levels.long()
    elif kind == "grad_dtype":
        grads[3] = grads[3].bfloat16()
    elif kind == "grad_layout":
        grads[1] = grads[1].permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
    return grads, boxes, levels, grad_out


BAD = [("cotangent_dtype", "cotangent dtype"), ("cotangent_layout", "cotangent must be contiguous"),
       ("cotangent_shape", "cotangent shape"), ("alignment", "16-byte aligned"),
       ("levels", "levels must be contiguous int32"), ("grad_dtype", "level 3: dtype"),
       ("grad_layout", "level 1: map gradient must be contiguous"),
       ("channels", "multiple of 8")]


@pytest.mark.parametrize("kind, match", BAD)
def test_adjoint_refuses_before_building(kind, match, tmp_path):
    kernel = RoIAlignKernel(build_dir=tmp_path)
    grads, boxes, levels, grad_out = _bad(kind)
    with pytest.raises(ValueError) as err:
        kernel.adjoint(grads, boxes, levels, grad_out)
    assert match in str(err.value) and "needs CUDA tensors" in str(err.value)
    assert kernel.adjoint_launches == 0 and kernel._lib is None and not any(tmp_path.iterdir())


def test_adjoint_names_every_problem(tmp_path):
    kernel = RoIAlignKernel(build_dir=tmp_path)
    grads, boxes, levels, grad_out = _adjoint_inputs()
    with pytest.raises(ValueError, match="needs CUDA tensors") as err:
        kernel.adjoint(grads, boxes, levels, grad_out)
    assert ";" not in str(err.value)  # CPU tensors are the only problem
    grads[2] = grads[2].double()
    with pytest.raises(ValueError) as err:
        kernel.adjoint(grads, boxes, levels.long(), grad_out.bfloat16()[:1])
    problems = str(err.value).split("; ")
    assert len(problems) == 5, problems
    for want in ("needs CUDA tensors", "levels must be", "cotangent dtype", "cotangent shape",
                 "level 2: dtype"):
        assert sum(want in p for p in problems) == 1, (want, problems)
    assert kernel.adjoint_launches == 0 and kernel._lib is None


def test_entry_points_are_defined_in_the_source():
    src = SOURCE.read_text()
    defined = set(re.findall(r'extern "C" int (\w+)\(', src))
    assert set(ENTRY_POINTS) <= defined, set(ENTRY_POINTS) - defined
    # _launch forms each name from the direction and the dtype.
    assert set(ENTRY_POINTS) == {f"skghoi_roi_align_{d}_{t}" for d in ("fwd", "bwd")
                                 for t in ("f32", "bf16")}
    assert 'f"skghoi_roi_align_{direction}_{dtype}"' in open(roi_align_cuda.__file__).read()


# --- 4. on the card ----------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", FIXTURES)
def test_kernel_on_card_matches_plain(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the adjoint kernel has no CPU form")
    maps, boxes = _fixture(name)
    b = torch.from_numpy(boxes).cuda()
    levels = fpn_level_assignment(b).contiguous()
    g = torch.from_numpy(_cotangent(boxes, maps[0].shape[-1])).cuda()
    shapes = [m.shape for m in maps]
    want = roi_align_adjoint(shapes, torch.float32, b, g)
    want_abs = roi_align_adjoint(shapes, torch.float32, b, g.abs())
    for dtype in (torch.float32, torch.bfloat16):
        runs = []
        for _ in range(2):
            grads = [torch.full(s, float("nan"), dtype=dtype, device="cuda") for s in shapes]
            runs.append(roi_align_cuda.roi_align_cuda.adjoint(grads, b, levels, g.to(dtype)))
        assert all(torch.equal(x, y) for x, y in zip(*runs))
        for got, ref, ref_abs in zip(runs[0], want, want_abs):
            if dtype == torch.float32:
                torch.testing.assert_close(got, ref, **KERNEL_TOL)
            else:
                assert ((got.float() - ref).abs() <= 2.0 ** -8 * (ref.abs() + ref_abs)).all()
