"""FrozenBatchNorm's fused epilogue, ``act(x * inv + shift [+ residual])``.

On the CPU (the plain path, and the autograd rule the card's backward kernel
follows):

- the module's path and ``FrozenBNFunction`` equal the eager composition the
  body ran before (BN, then the residual add, then a separate ReLU) bit for
  bit, forward and both gradients, in float32, bfloat16 and float64, channels
  last and NCHW, with and without the residual and the ReLU; so do a whole
  ResNet-50's outputs and gradients;
- the cached constants are computed again after ``load_state_dict``, an
  in-place ``copy_`` of a buffer, ``.to(bfloat16)`` and ``.double()``, and a
  second forward computes none (no ``rsqrt``);
- the kernel's wrapper refuses, on meta tensors, what a CUDA call could get
  wrong: a layout mismatch, a dtype mismatch, a non-contiguous input;
- the C entry points and their argument lists match the wrapper's.

On a card only (marker ``cuda``): the kernels against the plain composition
under ``torch.equal`` at the 53 sites' real shapes (832x1344, batch 8) in
bfloat16, float32 and float64, forward and both gradients; edge layouts;
NaN through the ReLU and its gradient; the launch counts of one SCG train
step.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke
from skghoi_torch.models.resnet import Bottleneck, FrozenBatchNorm, ResNet50
from skghoi_torch.ops import frozen_bn_cuda as fb

torch.set_num_threads(2)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float64": torch.float64}
LAYOUTS = {"channels_last": torch.channels_last, "nchw": torch.contiguous_format}


def _seeded_bn(channels, seed, dtype=torch.float32):
    """A FrozenBatchNorm with drawn statistics (float32 buffers, as every
    model keeps them) computing in ``dtype``."""
    rng = np.random.default_rng(seed)
    bn = FrozenBatchNorm(channels, dtype=dtype)
    bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, channels).astype(np.float32)))
    bn.bias.copy_(torch.from_numpy(rng.normal(0.0, 0.5, channels).astype(np.float32)))
    bn.running_mean.copy_(torch.from_numpy(rng.normal(0.0, 1.0, channels).astype(np.float32)))
    bn.running_var.copy_(torch.from_numpy(rng.uniform(1e-3, 4.0, channels).astype(np.float32)))
    return bn


def _old_bn(bn, x):
    """FrozenBatchNorm.forward as the body ran it before the fused epilogue:
    constants from the buffers on every call, one multiply-add."""
    ct = torch.promote_types(bn.running_var.dtype, torch.float32)
    inv = torch.rsqrt(bn.running_var.to(ct) + bn.eps) * bn.weight.to(ct)
    shift = bn.bias.to(ct) - bn.running_mean.to(ct) * inv
    dt = bn.compute_dtype
    return x.to(dt) * inv.to(dt).view(1, -1, 1, 1) + shift.to(dt).view(1, -1, 1, 1)


def _old_block(block, x):
    y = F.relu(_old_bn(block.bn1, block.conv1(x)))
    y = F.relu(_old_bn(block.bn2, block.conv2(y)))
    y = _old_bn(block.bn3, block.conv3(y))
    residual = x if block.downsample is None else _old_bn(block.downsample[1],
                                                          block.downsample[0](x))
    return F.relu(y + residual)


def _old_resnet(model, x):
    x = x.to(model.compute_dtype).contiguous(memory_format=torch.channels_last)
    x = F.max_pool2d(F.relu(_old_bn(model.bn1, model.conv1(x))), 3, stride=2, padding=1)
    if model.frozen_stages >= 0:
        x = x.detach()
    outputs = []
    for stage, layer in enumerate((model.layer1, model.layer2, model.layer3, model.layer4), 1):
        for block in layer:
            x = _old_block(block, x)
        if model.frozen_stages >= stage:
            x = x.detach()
        outputs.append(x)
    return tuple(outputs)


def _leaf(shape, seed, dtype, layout, scale=2.0):
    rng = np.random.default_rng(seed)
    t = torch.from_numpy(rng.normal(0.0, scale, shape)).to(dtype)
    return t.contiguous(memory_format=layout).requires_grad_(True)


def _grads(out, leaves, seed):
    cot = torch.from_numpy(np.random.default_rng(seed).normal(size=tuple(out.shape))).to(out.dtype)
    return torch.autograd.grad(out, leaves, cot)


# --- 1. the fused path against the eager composition -------------------------------

@pytest.mark.parametrize("relu", [False, True], ids=["bn", "bn_relu"])
@pytest.mark.parametrize("residual", [False, True], ids=["alone", "residual"])
@pytest.mark.parametrize("layout", list(LAYOUTS), ids=list(LAYOUTS))
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
def test_fused_site_equals_the_eager_composition(dtype, layout, residual, relu):
    """Forward, ``x``'s gradient and the residual's, bit for bit: through the
    module (the plain path on the CPU) and through ``FrozenBNFunction`` (the
    rule the card's backward kernel follows)."""
    dt, fmt = DTYPES[dtype], LAYOUTS[layout]
    bn = _seeded_bn(24, 3, dt)
    if dt == torch.float64:
        bn.double()
    shape = (2, 24, 5, 7)

    def leaves():
        x = _leaf(shape, 4, dt, fmt)
        return x, (_leaf(shape, 5, dt, fmt) if residual else None)

    x, r = leaves()
    want = _old_bn(bn, x)
    if residual:
        want = want + r
    if relu:
        want = F.relu(want)
    ins = [t for t in (x, r) if t is not None]
    want_grads = _grads(want, ins, 6)
    inv, shift = bn.constants()
    for run in (lambda x, r: bn(x, r, relu=relu),
                lambda x, r: fb.FrozenBNFunction.apply(x, r, inv, shift, relu)):
        x, r = leaves()
        got = run(x, r)
        ins = [t for t in (x, r) if t is not None]
        got_grads = _grads(got, ins, 6)
        assert got.dtype == dt and torch.equal(got, want)
        assert all(torch.equal(a, b) for a, b in zip(got_grads, want_grads))


@pytest.mark.parametrize("dtype,frozen_stages", [(torch.float32, 1), (torch.bfloat16, -1)],
                         ids=["float32-frozen1", "bfloat16-all"])
def test_resnet50_equals_the_eager_composition(dtype, frozen_stages):
    """A whole ResNet-50 (seeded statistics at every site): C2..C5 and every
    parameter's gradient equal the body as it ran before, bit for bit."""
    torch.manual_seed(0)
    model = ResNet50(dtype=dtype, frozen_stages=frozen_stages)
    for i, m in enumerate(m for m in model.modules() if isinstance(m, FrozenBatchNorm)):
        m.load_state_dict(_seeded_bn(m.weight.numel(), 100 + i).state_dict())
    images = torch.from_numpy(np.random.default_rng(7).uniform(0, 1, (1, 3, 64, 96))
                              .astype(np.float32))
    params = [p for p in model.parameters() if p.requires_grad]
    results = []
    for forward in (model, lambda x: _old_resnet(model, x)):
        outs = forward(images)
        loss = sum((o.float() * torch.linspace(-1, 1, o.numel()).view(o.shape)).sum()
                   for o in outs)
        results.append((outs, torch.autograd.grad(loss, params)))
    (got, got_g), (want, want_g) = results
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert len(got_g) == (42 if frozen_stages == 1 else 53)  # the convolutions' weights
    assert all(torch.equal(a, b) for a, b in zip(got_g, want_g))


def test_bottleneck_calls_each_site_once_with_its_epilogue():
    """bn1 and bn2 carry the ReLU, bn3 the residual and the ReLU, the
    projection's BN neither: one fused call a site."""
    calls = []
    block = Bottleneck(64, 16, stride=2)
    for name, m in block.named_modules():
        if isinstance(m, FrozenBatchNorm):
            m.register_forward_pre_hook(
                lambda m, a, k, name=name: calls.append((name, len(a) > 1 or "residual" in k,
                                                         k.get("relu", False))),
                with_kwargs=True)
    block(torch.randn(1, 64, 8, 8).contiguous(memory_format=torch.channels_last))
    assert calls == [("bn1", False, True), ("bn2", False, True), ("downsample.1", False, False),
                     ("bn3", True, True)]


# --- 2. the constants ---------------------------------------------------------------

def _load(bn):
    bn.load_state_dict(_seeded_bn(bn.weight.numel(), 9).state_dict())


def _copy(bn):
    bn.running_var.copy_(bn.running_var * 2.0)


MUTATIONS = {"load_state_dict": _load, "copy_": _copy,
             "to_bfloat16": lambda bn: bn.to(torch.bfloat16), "double": lambda bn: bn.double()}


@pytest.mark.parametrize("mutate", list(MUTATIONS), ids=list(MUTATIONS))
def test_constants_are_computed_again_after_a_change(mutate):
    bn = _seeded_bn(16, 8)
    first = bn.constants()
    assert all(a is b for a, b in zip(bn.constants(), first))  # cached
    MUTATIONS[mutate](bn)
    got = bn.constants()
    want = bn._fold()
    assert all(a is not b for a, b in zip(got, first))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not all(torch.equal(a, b) for a, b in zip(got, first))
    bn.compute_dtype = torch.float64
    assert bn.constants()[0].dtype == torch.float64


def test_inference_mode_buffers_and_constants():
    """Buffers made under inference_mode (no version counter) and constants
    computed under it both serve a later forward that needs a gradient."""
    with torch.inference_mode():
        made = _seeded_bn(16, 8)
        made(torch.randn(1, 16, 3, 3))
    reused = _seeded_bn(16, 8)
    with torch.inference_mode():
        reused(torch.randn(1, 16, 3, 3))
    for bn in (made, reused):
        x = _leaf((1, 16, 3, 3), 1, torch.float32, torch.contiguous_format)
        got = bn(x, relu=True)
        want = F.relu(_old_bn(bn, x))
        assert torch.equal(got, want)
        assert torch.equal(_grads(got, [x], 2)[0], _grads(want, [x], 2)[0])


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func.__name__)
        return func(*args, **(kwargs or {}))


def test_second_forward_computes_no_constants():
    model = ResNet50(dtype=torch.bfloat16, frozen_stages=1)
    images = torch.rand(1, 3, 64, 64)
    with _OpCount() as first:
        model(images)
    with _OpCount() as second:
        model(images)
    assert sum(op.startswith("rsqrt") for op in first.ops) == 53
    assert not any(op.startswith("rsqrt") for op in second.ops)
    # promote_types, add, rsqrt, mul, mul, sub and two casts to bfloat16 a site, once
    assert len(first.ops) - len(second.ops) == 8 * 53


# --- 3. the kernel's wrapper and its C interface ---------------------------------------

def _meta(shape, dtype=torch.bfloat16, fmt=torch.channels_last):
    t = torch.empty(shape, dtype=dtype, device="meta")
    return t.contiguous(memory_format=fmt) if t.dim() == 4 else t


MISUSES = {
    "layout": (lambda: (_meta((2, 16, 4, 6)), _meta(16), _meta(16),
                        _meta((2, 16, 4, 6), fmt=torch.contiguous_format)),
               "residual must have the input's layout"),
    "dtype": (lambda: (_meta((2, 16, 4, 6)), _meta(16, torch.float32), _meta(16), None),
              "inv dtype torch.float32, expected the input's torch.bfloat16"),
    "non_contiguous": (lambda: (_meta((2, 16, 4, 12))[..., ::2], _meta(16), _meta(16), None),
                       "input must be channels_last- or NCHW-contiguous"),
}


@pytest.mark.parametrize("misuse", list(MISUSES), ids=list(MISUSES))
def test_wrapper_refuses_misuse(misuse):
    make, message = MISUSES[misuse]
    kernel = fb.FrozenBNKernel()
    x, inv, shift, residual = make()
    with pytest.raises(ValueError) as err:
        kernel(x, inv, shift, residual, relu=True)
    problems = str(err.value).split("; ")
    assert any(message in p for p in problems) and "needs CUDA tensors" in problems[0], problems
    assert len(problems) == 2, problems
    assert kernel.launches == 0 and kernel._lib is None


def test_wrapper_refuses_cpu_and_grad():
    kernel = fb.FrozenBNKernel()
    x = torch.randn(1, 8, 2, 2, requires_grad=True)
    with pytest.raises(ValueError, match="needs CUDA tensors.*FrozenBNFunction"):
        kernel(x, torch.ones(8), torch.zeros(8))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kernel.backward(x.detach(), torch.ones(8))
    assert (kernel.launches, kernel.backward_launches) == (0, 0)


def test_entry_points_and_argument_lists_match_the_source():
    defined = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', fb.SOURCE.read_text()))
    assert set(fb.ENTRY_POINTS) == set(defined)
    kinds = {fb.ctypes.c_void_p: "pointer", fb.ctypes.c_int: "int", fb.ctypes.c_int64: "int64_t"}
    for name, argtypes in (("skghoi_frozen_bn_fwd", fb._FWD_ARGTYPES),
                           ("skghoi_frozen_bn_bwd", fb._BWD_ARGTYPES)):
        params = ["pointer" if "*" in p else p.split()[0] for p in defined[name].split(",")]
        assert params == [kinds[t] for t in argtypes], name


def test_the_sites_and_their_bytes_at_the_detect_shape():
    """53 sites (49 with the ReLU, 16 with the residual, 42 in layer2-4) that
    must move 9.89 GB a bf16 batch forward: 2.95 ms at 3.35 TB/s."""
    sites = chip_smoke.frozen_bn_sites()
    assert len(sites) == 53
    assert sum(relu for *_, relu in sites) == 49
    assert sum(residual for _, _, residual, _ in sites) == 16
    assert sum(name.startswith(("layer2", "layer3", "layer4")) for name, *_ in sites) == 42
    assert chip_smoke.frozen_bn_launches_per_step() == (53, 42)  # what phases 7 and 12 check
    assert chip_smoke.frozen_bn_bytes(sites) == 9_893_904_384
    assert sites[0] == ("bn1", (8, 64, 416, 672), False, True)


# --- 4. on the card ---------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the FrozenBN kernels have no CPU form")
    return torch.device("cuda")


def _site_inputs(shape, residual, dtype, gen, fmt=torch.channels_last):
    def draw(*s):
        return torch.randn(*s, generator=gen, device="cuda", dtype=torch.float64)

    x = (draw(*shape) * 2).to(dtype).contiguous(memory_format=fmt)
    res = (draw(*shape) * 2).to(dtype).contiguous(memory_format=fmt) if residual else None
    inv = (torch.rand(shape[1], generator=gen, device="cuda", dtype=torch.float64) * 2
           - 0.5).to(dtype)
    shift = (draw(shape[1]) * 0.5).to(dtype)
    gy = draw(*shape).to(dtype).contiguous(memory_format=fmt)
    return x, res, inv, shift, gy


def _card_vs_plain(shape, residual, relu, dtype, gen, fmt=torch.channels_last):
    x, res, inv, shift, gy = _site_inputs(shape, residual, dtype, gen, fmt)
    results = []
    for fn in (fb.frozen_bn_act, fb.frozen_bn_plain):
        xs = x.clone().requires_grad_(True)
        rs = res.clone().requires_grad_(True) if residual else None
        out = fn(xs, inv, shift, rs, relu)
        grads = torch.autograd.grad(out, [t for t in (xs, rs) if t is not None], gy)
        results.append((out.detach(), *grads))
    with torch.no_grad():
        results[0] = (fb.frozen_bn_act(x, inv, shift, res, relu), *results[0][1:])
    return results


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
def test_kernels_equal_the_plain_composition_at_the_53_sites(dtype):
    _card()
    dt = DTYPES[dtype]
    gen = torch.Generator(device="cuda").manual_seed(53)
    before = fb.frozen_bn_cuda.launches, fb.frozen_bn_cuda.backward_launches
    sites = chip_smoke.frozen_bn_sites()
    for name, shape, residual, relu in sites:
        got, want = _card_vs_plain(shape, residual, relu, dt, gen)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (name, dtype)
        assert got[0].is_contiguous(memory_format=torch.channels_last)
        del got, want
        torch.cuda.empty_cache()
    assert (fb.frozen_bn_cuda.launches - before[0],
            fb.frozen_bn_cuda.backward_launches - before[1]) == (2 * len(sites), len(sites))


EDGES = {  # shape, layout, an element offset of every tensor (misaligned vectors)
    "nchw_vec": ((2, 24, 8, 16), torch.contiguous_format, 0),
    "nchw_odd_plane": ((2, 24, 5, 7), torch.contiguous_format, 0),
    "nchw_vec_large": ((2, 24, 256, 260), torch.contiguous_format, 0),
    "nchw_odd_large": ((2, 24, 181, 389), torch.contiguous_format, 0),
    "nhwc_odd_channels": ((2, 13, 5, 7), torch.channels_last, 0),
    "nhwc_misaligned": ((2, 24, 5, 7), torch.channels_last, 1),
    "one_pixel": ((3, 32, 1, 1), torch.channels_last, 0),
    "large_grid": ((1, 8, 1031, 1029), torch.channels_last, 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("edge", list(EDGES), ids=list(EDGES))
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
def test_kernels_on_edge_layouts(dtype, edge):
    """The scalar path (indivisible or misaligned), NCHW and a grid-stride
    loop of several turns, all four epilogues."""
    _card()
    shape, fmt, offset = EDGES[edge]
    gen = torch.Generator(device="cuda").manual_seed(7)
    for residual in (False, True):
        for relu in (False, True):
            got, want = _card_vs_plain(shape, residual, relu, DTYPES[dtype], gen, fmt)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (edge, residual, relu)
    if offset:
        x, res, inv, shift, _ = _site_inputs(shape, True, DTYPES[dtype], gen)
        n = x.numel()
        buf = torch.empty(n + offset, dtype=x.dtype, device="cuda")
        shifted = buf[offset:].view(shape[0], shape[2], shape[3], shape[1]).permute(0, 3, 1, 2)
        shifted.copy_(x)
        assert shifted.data_ptr() % 16 and shifted.is_contiguous(memory_format=torch.channels_last)
        with torch.no_grad():
            assert torch.equal(fb.frozen_bn_act(shifted, inv, shift, res, True),
                               fb.frozen_bn_plain(x, inv, shift, res, True))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
def test_nan_passes_the_relu_and_its_gradient(dtype):
    """A NaN input gives a NaN output (clamp_min's rule), and a NaN output
    passes its gradient (threshold_backward's ``y <= 0`` is false for NaN)."""
    _card()
    dt = DTYPES[dtype]
    x = torch.tensor([float("nan"), -1.0, 2.0, float("-inf"), float("inf"), -0.0, 0.5, -3.0],
                     device="cuda", dtype=dt).view(1, 8, 1, 1).repeat(2, 1, 3, 3)
    x = x.contiguous(memory_format=torch.channels_last)
    inv = torch.ones(8, device="cuda", dtype=dt)
    shift = torch.zeros(8, device="cuda", dtype=dt)
    gy = torch.full_like(x, 3.0)
    outs = []
    for fn in (fb.frozen_bn_act, fb.frozen_bn_plain):
        xs = x.clone().requires_grad_(True)
        out = fn(xs, inv, shift, None, True)
        (g,) = torch.autograd.grad(out, xs, gy)
        outs.append((out.detach(), g))
    (out, g), (want, want_g) = outs
    assert torch.equal(out.isnan(), want.isnan()) and out.isnan().any()
    assert torch.equal(torch.nan_to_num(out), torch.nan_to_num(want))
    assert torch.equal(g, want_g) and (g[:, 0] == 3.0).all()


@pytest.mark.cuda
def test_one_scg_train_step_launches_53_forward_and_42_backward_kernels():
    _card()
    from skghoi_torch.entry import build_model, make_batch, verb_mask
    from skghoi_torch.ops.roi_align_cuda import roi_align_cuda
    from skghoi_torch.parallel.train_step import build_train_step
    from skghoi_torch.train.optimizer import build_optimizer

    roi_align_cuda.build()
    model = build_model(dtype=torch.bfloat16, device="cuda")
    step = build_train_step(model, build_optimizer(model), verb_mask(device="cuda"))
    batch = make_batch(2, (256, 384), with_targets=True, device="cuda")
    before = fb.frozen_bn_cuda.launches, fb.frozen_bn_cuda.backward_launches
    _, _, _, applied = step(batch, torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    assert applied
    assert (fb.frozen_bn_cuda.launches - before[0],
            fb.frozen_bn_cuda.backward_launches - before[1]) == (53, 42)
