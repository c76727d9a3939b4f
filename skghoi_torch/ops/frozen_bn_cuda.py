"""FrozenBatchNorm's epilogue, ``act(x * inv + shift [+ residual])``, as one
hand-written CUDA kernel a site each way, and its dispatch.

The kernels (``skghoi_torch/csrc/frozen_bn.cu``) replace no Pallas kernel:
on the TPU, XLA fuses the multiply-add, the residual add and the ReLU into
the convolution.  Eagerly the chain is four passes over the activation; the
forward kernel reads the activation (and the residual) once and writes the
output once, which is its bound on the card (bytes).  The backward kernel
takes the output's gradient to the input's, and to the residual's, in one
pass.  Both give the eager composition's bits (the source says how).

The source is built with ``nvcc`` into its own library on first use
(:mod:`skghoi_torch.ops.nvcc`).  :func:`frozen_bn_act` is the entry point:
CUDA tensors that need a gradient go through :class:`FrozenBNFunction`,
other CUDA tensors straight to the forward kernel, and CPU (and meta)
tensors through :func:`frozen_bn_plain`, the eager composition that autograd
differentiates.  A CUDA tensor never falls back: the kernel launches or the
wrapper raises.
"""

from __future__ import annotations

import ctypes
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from skghoi_torch.ops.nvcc import BUILD_DIR, build_library

Tensor = torch.Tensor

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "frozen_bn.cu"
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
ENTRY_POINTS = ("skghoi_frozen_bn_fwd", "skghoi_frozen_bn_bwd")
# dtype, x, residual, inv, shift, out, n, C, H*W, nhwc, relu, SMs, stream
_FWD_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int,
                 ctypes.c_int64] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
# dtype, grad_out, relu_out, inv, grad_x, grad_residual, n, C, H*W, nhwc, SMs, stream
_BWD_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int,
                 ctypes.c_int64] + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def frozen_bn_plain(x: Tensor, inv: Tensor, shift: Tensor, residual: Optional[Tensor] = None,
                    relu: bool = False) -> Tensor:
    """The eager composition the kernel reproduces: ``[N, C, H, W]`` ``x``,
    ``[C]`` constants in ``x``'s dtype."""
    y = x * inv.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)
    if residual is not None:
        y = y + residual
    return F.relu(y) if relu else y


def frozen_bn_backward_plain(grad_out: Tensor, inv: Tensor, relu_out: Optional[Tensor] = None,
                             residual_grad: bool = False) -> Tuple[Tensor, Optional[Tensor]]:
    """What autograd computes through :func:`frozen_bn_plain`: the ReLU's
    ``threshold_backward`` on its output ``relu_out`` (None: no ReLU), then
    the gradient of ``x`` and, with ``residual_grad``, the residual's."""
    g = grad_out if relu_out is None else torch.ops.aten.threshold_backward(grad_out, relu_out, 0)
    return g * inv.view(1, -1, 1, 1), (g if residual_grad else None)


class FrozenBNKernel:
    """The built library and the launch counts of the forward (``launches``)
    and backward (``backward_launches``) kernels."""

    def __init__(self):
        self.source = SOURCE
        self.launches = 0
        self.backward_launches = 0
        self.build_log = ""
        self.build_seconds: Optional[float] = None
        self._lib = None
        self._sms: Dict[int, int] = {}

    def build(self) -> ctypes.CDLL:
        """Compile (once per source content) and load the library."""
        if self._lib is not None:
            return self._lib
        t0 = time.perf_counter()
        lib, self.build_log = build_library(self.source, BUILD_DIR, "frozen_bn")
        lib.skghoi_frozen_bn_fwd.argtypes = _FWD_ARGTYPES
        lib.skghoi_frozen_bn_bwd.argtypes = _BWD_ARGTYPES
        for name in ENTRY_POINTS:
            getattr(lib, name).restype = ctypes.c_int
        self.build_seconds = time.perf_counter() - t0
        self._lib = lib
        return lib

    def __call__(self, x: Tensor, inv: Tensor, shift: Tensor, residual: Optional[Tensor] = None,
                 relu: bool = False) -> Tensor:
        """The forward kernel: ``act(x * inv + shift [+ residual])`` for a
        channels_last- or NCHW-contiguous ``[N, C, H, W]`` CUDA ``x`` (float32,
        bfloat16 or float64), ``[C]`` constants and a residual of ``x``'s
        dtype, shape and layout.  Refuses inputs that require grad (use
        :class:`FrozenBNFunction`)."""
        nhwc = _check(x, "input", {"inv": inv, "shift": shift},
                      {} if residual is None else {"residual": residual})
        out = torch.empty_like(x, memory_format=_format(nhwc))
        if x.numel():
            self._launch("fwd", x, nhwc, (residual, inv, shift, out), int(relu))
            self.launches += 1
        return out

    def backward(self, grad_out: Tensor, inv: Tensor, relu_out: Optional[Tensor] = None,
                 residual_grad: bool = False) -> Tuple[Tensor, Optional[Tensor]]:
        """The backward kernel: :func:`frozen_bn_backward_plain`'s gradients
        from ``grad_out`` (laid out as the forward's output), the output
        ``relu_out`` when the ReLU was on, and ``inv``."""
        nhwc = _check(grad_out, "gradient", {"inv": inv},
                      {} if relu_out is None else {"output": relu_out})
        grad_x = torch.empty_like(grad_out, memory_format=_format(nhwc))
        if relu_out is None:  # the residual's gradient is the output's, as autograd passes it
            grad_res = grad_out if residual_grad else None
            written = None
        else:
            grad_res = written = torch.empty_like(grad_x) if residual_grad else None
        if grad_out.numel():
            self._launch("bwd", grad_out, nhwc, (relu_out, inv, grad_x, written))
            self.backward_launches += 1
        return grad_x, grad_res

    def _launch(self, direction: str, x: Tensor, nhwc: bool, tensors, *flags) -> None:
        """One launch of ``skghoi_frozen_bn_<direction>`` on the current stream:
        ``x`` (the input or the output's gradient), the four other tensors of
        the C signature (None for a null pointer), then ``flags`` (the
        forward's ReLU)."""
        lib = self.build()
        fn = lib.skghoi_frozen_bn_fwd if direction == "fwd" else lib.skghoi_frozen_bn_bwd
        ptrs = [None if t is None else t.data_ptr() for t in tensors]
        err = fn(DTYPE_CODES[x.dtype], x.data_ptr(), *ptrs, x.numel(), x.shape[1],
                 x.shape[2] * x.shape[3], int(nhwc), *flags, self._sm_count(x.device),
                 torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"frozen_bn {direction} kernel launch failed: cudaError {err}")

    def _sm_count(self, device: torch.device) -> int:
        index = device.index
        if index not in self._sms:
            self._sms[index] = torch.cuda.get_device_properties(device).multi_processor_count
        return self._sms[index]


def _format(nhwc: bool) -> torch.memory_format:
    return torch.channels_last if nhwc else torch.contiguous_format


def _check(x: Tensor, what: str, constants: Dict[str, Tensor], alike: Dict[str, Tensor]) -> bool:
    """Raise one ValueError that names every problem with a kernel's inputs;
    returns whether ``x`` is laid out channels last (else NCHW)."""
    problems = []
    if x.dtype not in DTYPE_CODES:
        problems.append(f"{what} dtype {x.dtype}: the kernel takes float32, bfloat16 and float64")
    if x.device.type != "cuda":
        problems.append(f"the frozen_bn kernel needs CUDA tensors, got the {what} on {x.device}")
    elif x.device.index != torch.cuda.current_device():
        problems.append(f"the {what} is on {x.device}, the current device is "
                        f"cuda:{torch.cuda.current_device()}")
    nhwc = False
    if x.dim() != 4:
        problems.append(f"{what} must be [N, C, H, W], got {tuple(x.shape)}")
    else:
        nhwc = x.is_contiguous(memory_format=torch.channels_last)
        if not (nhwc or x.is_contiguous()):
            problems.append(f"{what} must be channels_last- or NCHW-contiguous, got strides "
                            f"{x.stride()}")
    channels = x.shape[1] if x.dim() == 4 else None
    for name, t in constants.items():
        if t.dtype != x.dtype:
            problems.append(f"{name} dtype {t.dtype}, expected the {what}'s {x.dtype}")
        if t.device != x.device:
            problems.append(f"{name} on {t.device}, expected {x.device}")
        if tuple(t.shape) != (channels,) or not t.is_contiguous():
            problems.append(f"{name} must be contiguous [{channels}], got {tuple(t.shape)}")
    for name, t in alike.items():
        if t.dtype != x.dtype:
            problems.append(f"{name} dtype {t.dtype}, expected the {what}'s {x.dtype}")
        if t.device != x.device:
            problems.append(f"{name} on {t.device}, expected {x.device}")
        if t.shape != x.shape:
            problems.append(f"{name} shape {tuple(t.shape)}, expected {tuple(x.shape)}")
        elif not t.is_contiguous(memory_format=_format(nhwc)):
            problems.append(f"{name} must have the {what}'s layout "
                            f"({'channels_last' if nhwc else 'NCHW'}-contiguous)")
    tensors = [x, *constants.values(), *alike.values()]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        problems.append("the frozen_bn kernel has no gradient of its own; call it under "
                        "torch.no_grad(), or through FrozenBNFunction")
    if problems:
        raise ValueError("; ".join(problems))
    return nhwc


frozen_bn_cuda = FrozenBNKernel()


class FrozenBNFunction(torch.autograd.Function):
    """``apply(x, residual, inv, shift, relu)``: the kernels as an autograd
    node (on CPU tensors, the plain versions).  Forward saves the output only
    where the ReLU is on (its gradient's mask); backward returns the
    gradients of ``x`` and of the residual, and none for the constants."""

    @staticmethod
    def forward(ctx, x: Tensor, residual: Optional[Tensor], inv: Tensor, shift: Tensor,
                relu: bool) -> Tensor:
        run = frozen_bn_cuda if x.device.type == "cuda" else frozen_bn_plain
        out = run(x, inv, shift, residual, relu)
        ctx.inv, ctx.relu = inv, relu
        ctx.format = _format(x.is_contiguous(memory_format=torch.channels_last))
        ctx.residual = residual is not None
        if relu:
            ctx.save_for_backward(out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out: Tensor):
        relu_out = ctx.saved_tensors[0] if ctx.relu else None
        residual_grad = ctx.residual and ctx.needs_input_grad[1]
        grad_out = grad_out.contiguous(memory_format=ctx.format)
        run = frozen_bn_cuda.backward if grad_out.device.type == "cuda" else frozen_bn_backward_plain
        grad_x, grad_res = run(grad_out, ctx.inv, relu_out, residual_grad)
        return (grad_x if ctx.needs_input_grad[0] else None), grad_res, None, None, None


def frozen_bn_act(x: Tensor, inv: Tensor, shift: Tensor, residual: Optional[Tensor] = None,
                  relu: bool = False) -> Tensor:
    """``act(x * inv + shift [+ residual])``: :class:`FrozenBNFunction` for
    CUDA tensors that need a gradient, the forward kernel for other CUDA
    tensors, :func:`frozen_bn_plain` for any other device."""
    if x.device.type != "cuda":
        return frozen_bn_plain(x, inv, shift, residual, relu)
    if torch.is_grad_enabled() and (x.requires_grad
                                    or (residual is not None and residual.requires_grad)):
        return FrozenBNFunction.apply(x, residual, inv, shift, relu)
    return frozen_bn_cuda(x, inv, shift, residual, relu)
