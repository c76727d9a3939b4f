"""Multi-scale RoIAlign as a hand-written CUDA kernel, and its dispatch.

The kernel (``skghoi_torch/csrc/roi_align.cu``) replaces the Pallas TPU kernel
``skghoi_tpu/ops/pallas_roi_align.py::pallas_multiscale_roi_align`` together
with its overflow rescue ``roi_align_exact``: it computes every box exactly,
sampling straight from global memory, so the 48x56 VMEM window and the rescue
path of the TPU version have no counterpart.  It is bound by bytes on the
card (see the source's header for what the design does about that).

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface on first use, into ``skghoi_torch/_build/`` (ignored by
git), and loaded with ``ctypes``.  Inference only: the adjoint comes with the
training slice, so inputs that require grad are refused.

:func:`roi_align_auto` launches the kernel for CUDA tensors and runs the plain
gather version (:func:`skghoi_torch.ops.roi_align.multiscale_roi_align`) for
CPU tensors.  A CUDA tensor never falls back: the kernel launches or the
wrapper raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional, Sequence

import torch

from skghoi_torch.constants import FPN_STRIDES, ROI_POOL_SIZE
from skghoi_torch.ops.roi_align import fpn_level_assignment, multiscale_roi_align

Tensor = torch.Tensor

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "roi_align.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError(f"nvcc not found (looked on PATH and in {cuda_home}/bin)")
    return found


class RoIAlignKernel:
    """The built library, its two entry points and the launch count."""

    def __init__(self, source: Path = SOURCE, build_dir: Path = BUILD_DIR):
        self.source = source
        self.build_dir = build_dir
        self.launches = 0
        self.build_log = ""
        self.build_seconds: Optional[float] = None
        self._lib = None

    def build(self) -> ctypes.CDLL:
        """Compile (once per source content) and load the library."""
        if self._lib is not None:
            return self._lib
        digest = hashlib.sha256(self.source.read_bytes() + " ".join(NVCC_FLAGS).encode())
        lib_path = self.build_dir / f"libroi_align_{digest.hexdigest()[:16]}.so"
        t0 = time.perf_counter()
        if not lib_path.exists():
            self.build_dir.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
                                  capture_output=True, text=True, check=False)
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.source}:\n{self.build_log}")
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(str(lib_path))
        for name in ("skghoi_roi_align_fwd_f32", "skghoi_roi_align_fwd_bf16"):
            fn = getattr(lib, name)
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
        self.build_seconds = time.perf_counter() - t0
        self._lib = lib
        return lib

    def __call__(self, feature_maps: Sequence[Tensor], boxes: Tensor,
                 strides: Sequence[int] = FPN_STRIDES) -> Tensor:
        """``[B, N, 4]`` float32 boxes over four contiguous ``[B, H_l, W_l, C]``
        CUDA maps (float32 or bfloat16) -> ``[B, N, 7, 7, C]`` in the maps' dtype."""
        maps = tuple(feature_maps)
        _check_inputs(maps, boxes, strides)
        lib = self.build()
        bsz, n = boxes.shape[:2]
        c = maps[0].shape[-1]
        levels = fpn_level_assignment(boxes).contiguous()
        out = torch.empty((bsz, n, ROI_POOL_SIZE, ROI_POOL_SIZE, c),
                          dtype=maps[0].dtype, device=boxes.device)
        hw = (ctypes.c_int * 8)(*[d for fm in maps for d in fm.shape[1:3]])
        scales = (ctypes.c_float * 4)(*[1.0 / s for s in strides])
        fn = (lib.skghoi_roi_align_fwd_bf16 if maps[0].dtype == torch.bfloat16
              else lib.skghoi_roi_align_fwd_f32)
        err = fn(*[fm.data_ptr() for fm in maps], hw, scales, boxes.data_ptr(),
                 levels.data_ptr(), out.data_ptr(), bsz, n, c,
                 torch.cuda.current_stream(boxes.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"roi_align kernel launch failed: cudaError {err}")
        self.launches += 1
        return out


def _check_inputs(maps, boxes: Tensor, strides) -> None:
    if len(maps) != 4 or len(strides) != 4:
        raise ValueError("expected four FPN levels and four strides")
    if boxes.device.type != "cuda":
        raise ValueError(f"roi_align kernel needs CUDA tensors, got boxes on {boxes.device}")
    if boxes.dtype != torch.float32 or boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be float32 [B, N, 4], got {boxes.dtype} {tuple(boxes.shape)}")
    if not boxes.is_contiguous():
        raise ValueError("boxes must be contiguous")
    dtype = maps[0].dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"feature maps must be float32 or bfloat16, got {dtype}")
    bsz, c = boxes.shape[0], maps[0].shape[-1]
    if c % 2:
        raise ValueError(f"channel count must be even, got {c}")
    for l, fm in enumerate(maps):
        if fm.device != boxes.device or fm.dtype != dtype:
            raise ValueError(f"level {l}: {fm.dtype} on {fm.device}, expected {dtype} on {boxes.device}")
        if fm.dim() != 4 or fm.shape[0] != bsz or fm.shape[-1] != c:
            raise ValueError(f"level {l}: shape {tuple(fm.shape)}, expected [{bsz}, H, W, {c}]")
        if not fm.is_contiguous():
            raise ValueError(f"level {l}: feature map must be contiguous NHWC")
    if boxes.requires_grad or any(fm.requires_grad for fm in maps):
        raise ValueError("roi_align kernel is forward only; call it under torch.no_grad()")


roi_align_cuda = RoIAlignKernel()


def roi_align_auto(feature_maps: Sequence[Tensor], boxes: Tensor) -> Tensor:
    """The CUDA kernel for CUDA tensors, the plain gather version for CPU tensors."""
    if boxes.device.type == "cuda":
        return roi_align_cuda(feature_maps, boxes)
    if boxes.device.type != "cpu":
        raise ValueError(f"unsupported device {boxes.device}")
    return multiscale_roi_align(feature_maps, boxes)
