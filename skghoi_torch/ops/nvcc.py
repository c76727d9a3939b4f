"""Build a CUDA source of ``skghoi_torch/csrc/`` into a shared library with a
plain C interface, and load it with ``ctypes``.

``nvcc`` compiles for ``sm_90a`` on first use, into ``skghoi_torch/_build/``
(ignored by git), under a name that carries a digest of the source and the
flags, so an edited source is built again and an unchanged one is loaded.
Processes that build the same library at once each write a file of their
own and rename it into place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError(f"nvcc not found (looked on PATH and in {cuda_home}/bin)")
    return found


def build_library(source: Path, build_dir: Path, stem: str) -> Tuple[ctypes.CDLL, str]:
    """Compile ``source`` (once per content) into ``build_dir/lib<stem>_<digest>.so``
    and load it; returns the library and the compiler's output ("" when the
    library was already built)."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib_path = build_dir / f"lib{stem}_{digest.hexdigest()[:16]}.so"
    log = ""
    if not lib_path.exists():
        build_dir.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                              capture_output=True, text=True, check=False)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{log}")
        os.replace(tmp, lib_path)
    return ctypes.CDLL(str(lib_path)), log
