"""AdaMixer's adaptive 3D sampling as hand-written CUDA kernels, one launch a
stage each way.

The kernels (``skghoi_torch/csrc/adamixer_sample.cu``) replace no Pallas
kernel: the JAX package samples with XLA gathers.  Eagerly the sampling is
some 220 launches a stage and its autograd backward as many again; the
forward kernel reads each point's 16 taps and writes its output once, bit
for bit the eager gathers' result, and the adjoint kernel adds the level
maps' gradients with vector atomics and reduces the points' and the level
weights' gradients in the same pass (the source's header says how).

The source is built with ``nvcc`` into its own library on first use
(:mod:`skghoi_torch.ops.nvcc`).  ``detect.adamixer`` runs them through its
``SampleFunction`` for every CUDA tensor, and its eager gathers on any other
device.  The wrapper never falls back: it launches or raises, naming what
it does not take (:func:`refusal`).
"""

from __future__ import annotations

import ctypes
import time
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch

from skghoi_torch.ops.nvcc import BUILD_DIR, build_library

Tensor = torch.Tensor

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "adamixer_sample.cu"
DTYPE_CODES = {torch.float32: 0, torch.float64: 2}
MAX_LEVELS = 4
ENTRY_POINTS = ("skghoi_adamixer_sample_fwd", "skghoi_adamixer_sample_bwd")
# dtype, feats[], heights[], widths[], inv_strides[], levels, pts, wts, out, B*G, M, c, stream
_FWD_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 3
                 + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])
# dtype, feats[], grads[], heights[], widths[], inv_strides[], levels, pts, wts, grad_out,
# grad_pts, grad_wts, B*G, M, c, stream
_BWD_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 5
                 + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])


def refusal(feats: Sequence[Tensor], points: Tensor, wts: Tensor) -> Optional[str]:
    """Why the kernels do not take these tensors, or None where they do: they
    take float32 or float64 throughout, CUDA on the current device, 1 to 4
    levels ``[B, G, H*W, c]``, ``points [B, G, M, 3]`` and ``wts [B, G, M,
    levels]``, each contiguous and 16-byte aligned, ``c`` a whole number of
    16-byte vectors."""
    tensors = [*feats, points, wts]
    if points.dtype not in DTYPE_CODES:
        return f"dtype {points.dtype}: the kernels take float32 and float64"
    if any(t.device.type != "cuda" for t in tensors):
        return f"the kernels need CUDA tensors, got {sorted({str(t.device) for t in tensors})}"
    if any(t.dtype != points.dtype for t in tensors):
        return f"dtypes {sorted({str(t.dtype) for t in tensors})}: one dtype throughout"
    if any(t.device != points.device for t in tensors) or (
            points.device.index != torch.cuda.current_device()):
        return (f"tensors on {sorted({str(t.device) for t in tensors})}, the current device is "
                f"cuda:{torch.cuda.current_device()}")
    c = feats[0].shape[-1] if feats and feats[0].dim() == 4 else None
    if (not 1 <= len(feats) <= MAX_LEVELS or points.dim() != 4 or points.shape[-1] != 3
            or tuple(wts.shape) != (*points.shape[:3], len(feats))
            or any(f.dim() != 4 or f.shape[:2] != points.shape[:2] or f.shape[-1] != c
                   for f in feats)):
        return (f"shapes: levels {[tuple(f.shape) for f in feats]}, points "
                f"{tuple(points.shape)}, wts {tuple(wts.shape)}; the kernels take 1-{MAX_LEVELS} "
                f"levels [B, G, H*W, c], points [B, G, M, 3] and wts [B, G, M, levels]")
    if c * points.element_size() % 16:
        return f"{c} channels a group: not a whole number of 16-byte vectors"
    if not all(t.is_contiguous() for t in tensors):
        return "every tensor must be contiguous"
    if any(t.data_ptr() % 16 for t in tensors):
        return "every tensor must start on a 16-byte boundary"
    return None


class SampleKernel:
    """The built library and the launch counts of the forward (``launches``)
    and adjoint (``backward_calls``) kernels."""

    def __init__(self):
        self.source = SOURCE
        self.launches = 0
        self.backward_calls = 0
        self.build_log = ""
        self.build_seconds: Optional[float] = None
        self._lib = None

    def build(self) -> ctypes.CDLL:
        """Compile (once per source content) and load the library."""
        if self._lib is not None:
            return self._lib
        t0 = time.perf_counter()
        lib, self.build_log = build_library(self.source, BUILD_DIR, "adamixer_sample")
        lib.skghoi_adamixer_sample_fwd.argtypes = _FWD_ARGTYPES
        lib.skghoi_adamixer_sample_bwd.argtypes = _BWD_ARGTYPES
        for name in ENTRY_POINTS:
            getattr(lib, name).restype = ctypes.c_int
        self.build_seconds = time.perf_counter() - t0
        self._lib = lib
        return lib

    def __call__(self, feats: Sequence[Tensor], hw: Sequence[Tuple[int, int]],
                 inv_strides: Sequence[float], points: Tensor, wts: Tensor) -> Tensor:
        """The forward kernel: ``[B, G, M, c]`` samples of ``feats`` (levels
        ``[B, G, H*W, c]`` of sizes ``hw``) at ``points [B, G, M, 3]`` (x, y
        in image pixels, a level's grid at ``inv_strides`` of them), each level
        weighted by ``wts [B, G, M, levels]``."""
        _check(feats, hw, inv_strides, points, wts)
        out = torch.empty((*points.shape[:3], feats[0].shape[-1]), dtype=points.dtype,
                          device=points.device)
        lib = self.build()
        err = lib.skghoi_adamixer_sample_fwd(
            DTYPE_CODES[points.dtype], _pointers(feats), *_level_args(hw, inv_strides),
            len(feats), points.data_ptr(), wts.data_ptr(), out.data_ptr(),
            *_grid_args(points, feats), _stream(points))
        if err != 0:
            raise RuntimeError(f"adamixer_sample forward kernel launch failed: cudaError {err}")
        self.launches += 1
        return out

    def adjoint(self, grad_out: Tensor, feats: Sequence[Tensor], hw: Sequence[Tuple[int, int]],
                inv_strides: Sequence[float], points: Tensor,
                wts: Tensor) -> Tuple[Tensor, Tensor, list]:
        """The adjoint kernel: from the output's gradient ``[B, G, M, c]``,
        the gradients of ``points`` (z's 0: the level weights carry it), of
        ``wts`` and of each level (one zeroed buffer for all, filled by
        atomics)."""
        _check(feats, hw, inv_strides, points, wts)
        if grad_out.shape != (*points.shape[:3], feats[0].shape[-1]) or not (
                grad_out.dtype == points.dtype and grad_out.device == points.device
                and grad_out.is_contiguous() and grad_out.data_ptr() % 16 == 0):
            raise ValueError(f"the output's gradient must be a contiguous, 16-byte aligned "
                             f"{points.dtype} [B, G, M, c] tensor on {points.device}, got "
                             f"{grad_out.dtype} {tuple(grad_out.shape)} on {grad_out.device}")
        flat = torch.zeros(sum(f.numel() for f in feats), dtype=points.dtype, device=points.device)
        grads = [g.view(f.shape) for g, f in zip(flat.split([f.numel() for f in feats]), feats)]
        grad_pts, grad_wts = torch.empty_like(points), torch.empty_like(wts)
        lib = self.build()
        err = lib.skghoi_adamixer_sample_bwd(
            DTYPE_CODES[points.dtype], _pointers(feats), _pointers(grads),
            *_level_args(hw, inv_strides), len(feats), points.data_ptr(), wts.data_ptr(),
            grad_out.data_ptr(), grad_pts.data_ptr(), grad_wts.data_ptr(),
            *_grid_args(points, feats), _stream(points))
        if err != 0:
            raise RuntimeError(f"adamixer_sample adjoint kernel launch failed: cudaError {err}")
        self.backward_calls += 1
        return grad_pts, grad_wts, grads


def _check(feats, hw, inv_strides, points, wts) -> None:
    """Raise one ValueError that names what the kernels do not take."""
    problems = [r for r in (refusal(feats, points, wts),) if r]
    if len(hw) != len(feats) or len(inv_strides) != len(feats) or any(
            f.dim() != 4 or f.shape[2] != h * w for f, (h, w) in zip(feats, hw)):
        problems.append(f"level sizes {list(hw)} and {len(inv_strides)} strides do not match the "
                        f"levels {[tuple(f.shape) for f in feats]}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (*feats, points, wts)):
        problems.append("the kernels have no gradient of their own; call them under "
                        "torch.no_grad(), or through adamixer.SampleFunction")
    if problems:
        raise ValueError("adamixer_sample: " + "; ".join(problems))


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _level_args(hw, inv_strides):
    n = len(hw)
    return ((ctypes.c_int * n)(*(h for h, _ in hw)), (ctypes.c_int * n)(*(w for _, w in hw)),
            (ctypes.c_double * n)(*map(float, inv_strides)))


def _grid_args(points, feats):
    b, g, m, _ = points.shape
    return b * g, m, feats[0].shape[-1]


def _stream(t: Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


sample_cuda = SampleKernel()
