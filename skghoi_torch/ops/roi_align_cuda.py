"""Multi-scale RoIAlign as hand-written CUDA kernels, forward and adjoint,
and their dispatch.

The forward kernel (``skghoi_torch/csrc/roi_align.cu``) replaces the Pallas
TPU kernel ``skghoi_tpu/ops/pallas_roi_align.py::pallas_multiscale_roi_align``
together with its overflow rescue ``roi_align_exact``: it computes every box
exactly, so the 48x56 VMEM window and the rescue path of the TPU version have
no counterpart.  Its roofline bound on the card is bytes: each work item
(box, 256-byte channel slice) stages its distinct map cells in shared memory
with 16-byte asynchronous copies and interpolates from there (the source's
header says how, and what limits it now).  The adjoint kernel, in the same
source, replaces that kernel's custom-VJP backward ``_roi_backward``: each
CTA writes one tile of one level's gradient whole, summing the boxes that
reach it in a fixed order, with no atomics.

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface on first use, into ``skghoi_torch/_build/`` (ignored by
git), and loaded with ``ctypes``.  A direct call of the forward refuses
inputs that require grad; :class:`RoIAlignFunction` is the differentiable
form: its forward launches the forward kernel, its backward the adjoint
kernel, on the card both.  The plain versions,
:func:`skghoi_torch.ops.roi_align.multiscale_roi_align` and
:func:`skghoi_torch.ops.roi_align.roi_align_adjoint`, serve the CPU and the
checks; nothing calls them on the card's path.

:func:`roi_align_auto` runs :class:`RoIAlignFunction` for CUDA tensors and the
plain gather version (differentiated by autograd) for CPU tensors.  A CUDA
tensor never falls back: the kernel launches or the wrapper raises.
"""

from __future__ import annotations

import ctypes
import time
from pathlib import Path
from typing import Optional, Sequence

import torch

from skghoi_torch.constants import FPN_STRIDES, ROI_POOL_SIZE
from skghoi_torch.ops.nvcc import BUILD_DIR, build_library
from skghoi_torch.ops.roi_align import fpn_level_assignment, multiscale_roi_align

Tensor = torch.Tensor

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "roi_align.cu"

# The library's C entry points: forward and adjoint, float32 and bfloat16.
ENTRY_POINTS = ("skghoi_roi_align_fwd_f32", "skghoi_roi_align_fwd_bf16",
                "skghoi_roi_align_bwd_f32", "skghoi_roi_align_bwd_bf16")
# All four take: maps (forward) or their gradients (adjoint) x4, hw, scales,
# boxes, levels, out (forward) or cotangent (adjoint), n_images, n_boxes, c,
# stream.
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


class RoIAlignKernel:
    """The built library, its entry points and the launch counts of the
    forward (``launches``) and the adjoint (``adjoint_launches``)."""

    def __init__(self, build_dir: Path = BUILD_DIR):
        self.source = SOURCE
        self.build_dir = build_dir
        self.launches = 0
        self.adjoint_launches = 0
        self.build_log = ""
        self.build_seconds: Optional[float] = None
        self._lib = None

    def build(self) -> ctypes.CDLL:
        """Compile (once per source content) and load the library."""
        if self._lib is not None:
            return self._lib
        t0 = time.perf_counter()
        lib, self.build_log = build_library(self.source, self.build_dir, "roi_align")
        for name in ENTRY_POINTS:
            fn = getattr(lib, name)
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
        self.build_seconds = time.perf_counter() - t0
        self._lib = lib
        return lib

    def __call__(self, feature_maps: Sequence[Tensor], boxes: Tensor,
                 strides: Sequence[int] = FPN_STRIDES) -> Tensor:
        """``[B, N, 4]`` float32 boxes over four contiguous ``[B, H_l, W_l, C]``
        CUDA maps (float32 or bfloat16, ``C % 8 == 0``) -> ``[B, N, 7, 7, C]``
        in the maps' dtype."""
        maps = tuple(feature_maps)
        _check_inputs(maps, boxes, strides)
        levels = fpn_level_assignment(boxes).contiguous()
        out = torch.empty((*boxes.shape[:2], ROI_POOL_SIZE, ROI_POOL_SIZE, maps[0].shape[-1]),
                          dtype=maps[0].dtype, device=boxes.device)
        return self._run(maps, boxes, levels, out, strides)

    def launch(self, maps: Sequence[Tensor], boxes: Tensor, levels: Tensor, out: Tensor,
               strides: Sequence[int] = FPN_STRIDES) -> Tensor:
        """The kernel alone: ``levels`` (int32 ``[B, N]``, from
        :func:`fpn_level_assignment`) and ``out`` are given by the caller."""
        maps = tuple(maps)
        _check_inputs(maps, boxes, strides)
        bsz, n = boxes.shape[:2]
        c = maps[0].shape[-1]
        if (levels.dtype != torch.int32 or levels.shape != (bsz, n) or not levels.is_contiguous()
                or levels.device != boxes.device):
            raise ValueError(f"levels must be contiguous int32 [{bsz}, {n}] on {boxes.device}")
        if (out.dtype != maps[0].dtype or out.shape != (bsz, n, ROI_POOL_SIZE, ROI_POOL_SIZE, c)
                or not out.is_contiguous() or out.device != boxes.device or out.data_ptr() % 16):
            raise ValueError("out must be a contiguous, 16-byte aligned [B, N, 7, 7, C] "
                             "tensor in the maps' dtype")
        return self._run(maps, boxes, levels, out, strides)

    def adjoint(self, grads: Sequence[Tensor], boxes: Tensor, levels: Tensor, grad_out: Tensor,
                strides: Sequence[int] = FPN_STRIDES) -> tuple:
        """The adjoint kernel: writes every element of ``grads``, the
        gradients of the four maps (contiguous ``[B, H_l, W_l, C]`` CUDA
        tensors, float32 or bfloat16, given by the caller), from the
        ``[B, N, 7, 7, C]`` cotangent ``grad_out`` in their dtype; float32
        sums, one cast at the end.  ``levels`` as for :meth:`launch`: the
        forward's.  Returns ``grads``."""
        grads = tuple(grads)
        _check_adjoint_inputs(grads, boxes, levels, grad_out, strides)
        if all(g.numel() == 0 for g in grads):
            return grads
        self._launch("bwd", grads, boxes, levels, grad_out, strides)
        self.adjoint_launches += 1
        return grads

    def _run(self, maps, boxes: Tensor, levels: Tensor, out: Tensor, strides) -> Tensor:
        if out.numel() == 0:
            return out
        self._launch("fwd", maps, boxes, levels, out, strides)
        self.launches += 1
        return out

    def _launch(self, direction: str, maps, boxes: Tensor, levels: Tensor, other: Tensor,
                strides) -> None:
        """One launch of ``skghoi_roi_align_{direction}_{dtype}`` on the
        current stream; ``maps`` are the maps or their gradients, ``other``
        the output or the cotangent."""
        bsz, n = boxes.shape[:2]
        c = maps[0].shape[-1]
        lib = self.build()
        hw = (ctypes.c_int * 8)(*[d for fm in maps for d in fm.shape[1:3]])
        scales = (ctypes.c_float * 4)(*[1.0 / s for s in strides])
        dtype = "bf16" if maps[0].dtype == torch.bfloat16 else "f32"
        fn = getattr(lib, f"skghoi_roi_align_{direction}_{dtype}")
        err = fn(*[fm.data_ptr() for fm in maps], hw, scales, boxes.data_ptr(),
                 levels.data_ptr(), other.data_ptr(), bsz, n, c,
                 torch.cuda.current_stream(boxes.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"roi_align {direction} kernel launch failed: cudaError {err}")


def _check_inputs(maps, boxes: Tensor, strides) -> None:
    """Raise one ValueError that names every problem with the inputs."""
    if len(maps) != 4 or len(strides) != 4:
        raise ValueError("expected four FPN levels and four strides")
    if boxes.dtype != torch.float32 or boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be float32 [B, N, 4], got {boxes.dtype} {tuple(boxes.shape)}")
    problems = []
    if boxes.device.type != "cuda":
        problems.append(f"roi_align kernel needs CUDA tensors, got boxes on {boxes.device}")
    if not boxes.is_contiguous():
        problems.append("boxes must be contiguous")
    problems += _level_problems(maps, boxes, "feature map")
    for l, fm in enumerate(maps):
        if fm.dim() == 4 and fm.shape[2] * fm.shape[3] * fm.element_size() >= 2**31:
            problems.append(f"level {l}: a map row must be under 2 GiB (32-bit column offsets)")
    if any(t.data_ptr() % 16 for t in (boxes, *maps)):
        problems.append("boxes and feature maps must be 16-byte aligned")
    if boxes.requires_grad or any(fm.requires_grad for fm in maps):
        problems.append("the roi_align kernel has no gradient of its own; call it under "
                        "torch.no_grad(), or through RoIAlignFunction")
    if problems:
        raise ValueError("; ".join(problems))


def _level_problems(tensors, boxes: Tensor, what: str) -> list:
    """What is wrong with four ``[B, H_l, W_l, C]`` tensors, the maps or their
    gradients, for the kernels: dtype, channels, device, shape, layout."""
    dtype, c, bsz = tensors[0].dtype, tensors[0].shape[-1], boxes.shape[0]
    problems = []
    if dtype not in (torch.float32, torch.bfloat16):
        problems.append(f"{what}s must be float32 or bfloat16, got {dtype}")
    if c % 8:
        problems.append(f"channel count must be a multiple of 8 (16-byte vectors), got {c}")
    for l, t in enumerate(tensors):
        if t.dtype != dtype:
            problems.append(f"level {l}: dtype {t.dtype}, expected {dtype} like level 0")
        if t.device != boxes.device:
            problems.append(f"level {l}: on {t.device}, expected {boxes.device}")
        if t.dim() != 4 or t.shape[0] != bsz or t.shape[-1] != c:
            problems.append(f"level {l}: shape {tuple(t.shape)}, expected [{bsz}, H, W, {c}]")
        if not t.is_contiguous():
            problems.append(f"level {l}: {what} must be contiguous NHWC")
    return problems


def _check_adjoint_inputs(grads, boxes: Tensor, levels: Tensor, grad_out: Tensor,
                          strides) -> None:
    """Raise one ValueError that names every problem with the adjoint's inputs."""
    if len(grads) != 4 or len(strides) != 4:
        raise ValueError("expected four FPN levels and four strides")
    if boxes.dtype != torch.float32 or boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be float32 [B, N, 4], got {boxes.dtype} {tuple(boxes.shape)}")
    problems = []
    dev = boxes.device
    if dev.type != "cuda":
        problems.append(f"roi_align adjoint kernel needs CUDA tensors, got boxes on {dev}")
    if not boxes.is_contiguous():
        problems.append("boxes must be contiguous")
    problems += _level_problems(grads, boxes, "map gradient")
    bsz, n = boxes.shape[:2]
    dtype, c = grads[0].dtype, grads[0].shape[-1]
    if (levels.dtype != torch.int32 or tuple(levels.shape) != (bsz, n) or not levels.is_contiguous()
            or levels.device != dev):
        problems.append(f"levels must be contiguous int32 [{bsz}, {n}] on {dev}")
    if grad_out.dtype != dtype:
        problems.append(f"cotangent dtype {grad_out.dtype}, expected the maps' {dtype}")
    if tuple(grad_out.shape) != (bsz, n, ROI_POOL_SIZE, ROI_POOL_SIZE, c):
        problems.append(f"cotangent shape {tuple(grad_out.shape)}, expected "
                        f"[{bsz}, {n}, {ROI_POOL_SIZE}, {ROI_POOL_SIZE}, {c}]")
    if not grad_out.is_contiguous():
        problems.append("cotangent must be contiguous")
    if grad_out.device != dev:
        problems.append(f"cotangent on {grad_out.device}, expected {dev}")
    if any(t.data_ptr() % 16 for t in (boxes, grad_out, *grads)):
        problems.append("boxes, cotangent and map gradients must be 16-byte aligned")
    if problems:
        raise ValueError("; ".join(problems))


roi_align_cuda = RoIAlignKernel()


class RoIAlignFunction(torch.autograd.Function):
    """The kernels as an autograd node: ``apply(boxes, *maps)``.

    Forward launches the forward kernel of :data:`roi_align_cuda` on the maps
    (detached views: no copy, NHWC contiguity kept) and saves the boxes and
    their levels.  Backward launches the adjoint kernel with those levels: it
    returns contiguous ``[B, H_l, W_l, C]`` gradients in the maps' dtype and
    none for the boxes.  ``backward_calls`` counts backward passes.
    """

    backward_calls = 0

    @staticmethod
    def forward(ctx, boxes: Tensor, *maps: Tensor) -> Tensor:
        maps = [fm.detach() for fm in maps]
        boxes = boxes.detach()
        levels = fpn_level_assignment(boxes).contiguous()
        out = torch.empty((*boxes.shape[:2], ROI_POOL_SIZE, ROI_POOL_SIZE, maps[0].shape[-1]),
                          dtype=maps[0].dtype, device=boxes.device)
        roi_align_cuda.launch(maps, boxes, levels, out)
        ctx.map_shapes = [tuple(fm.shape) for fm in maps]
        ctx.map_dtype = maps[0].dtype
        ctx.save_for_backward(boxes, levels)
        return out

    @staticmethod
    def backward(ctx, grad_out: Tensor):
        boxes, levels = ctx.saved_tensors
        RoIAlignFunction.backward_calls += 1
        grad_out = grad_out.contiguous()
        if grad_out.data_ptr() % 16:  # a view at an odd offset; the kernel copies 16 bytes at a time
            grad_out = grad_out.clone()
        grads = [torch.empty(s, dtype=ctx.map_dtype, device=boxes.device) for s in ctx.map_shapes]
        return (None, *roi_align_cuda.adjoint(grads, boxes, levels, grad_out))


def roi_align_auto(feature_maps: Sequence[Tensor], boxes: Tensor) -> Tensor:
    """:class:`RoIAlignFunction` (the forward and adjoint kernels) for CUDA
    tensors, the plain gather version for CPU tensors."""
    if boxes.device.type == "cuda":
        return RoIAlignFunction.apply(boxes, *feature_maps)
    if boxes.device.type != "cpu":
        raise ValueError(f"unsupported device {boxes.device}")
    return multiscale_roi_align(feature_maps, boxes)
