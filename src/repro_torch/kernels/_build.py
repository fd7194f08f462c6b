"""The one ``nvcc`` build-and-load helper of the port's CUDA C++ kernels.

Each kernel module keeps its source under ``csrc/`` and calls
:func:`build_library` at its first launch. The source is compiled for
``sm_90a`` into a shared library with a plain C interface, named by a hash
of the source and the flags, in the module's ``_build/`` directory (listed
in ``.gitignore``); the module then binds its entry points with ``ctypes``.
Nothing is built at import: the CPU tests import every module on a machine
without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build_library"]

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def build_library(src: Path, info: dict, flags: tuple = NVCC_FLAGS) -> ctypes.CDLL:
    """Compile ``src`` with ``nvcc`` into ``_build/lib<stem>_<hash>.so``
    beside its ``csrc/`` directory, unless that file exists, and load it.

    The compiler writes to a temporary file that is renamed into place, so
    two processes building at once never load a half-written library. The
    seconds taken, the ``-Xptxas -v`` report (empty when the library was
    already built) and the path go into ``info``; a failed build raises."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("the CUDA toolkit (nvcc) was not found: set CUDA_HOME")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    build_dir = src.parent.parent / "_build"
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    so_path = build_dir / f"lib{src.stem}_{digest.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    log = ""
    if not so_path.exists():
        build_dir.mkdir(parents=True, exist_ok=True)
        tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([nvcc, *flags, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(str(so_path))
    info.update(seconds=time.perf_counter() - t0, log=log, path=str(so_path))
    return lib
