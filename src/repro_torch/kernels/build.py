"""Build a kernel's CUDA source into a shared library and load it.

Each kernel is one ``.cu`` file with a plain C entry point, compiled by
``nvcc`` for Hopper (``sm_90a``) into
``build/repro_torch_kernels/<source-hash>/`` at the root of the checkout
the first time it is needed, then loaded with ``ctypes``.  The hash
covers every file in the source's directory (the ``.cu`` and the headers
it includes) and the flags, so an edited kernel or header is rebuilt and
an unchanged one is reused.  A failed build raises with nvcc's output.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is not None:
        path = Path(CUDA_HOME) / "bin" / "nvcc"
        if path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built from source at first use and need "
                           "the CUDA toolkit")
    return found


def library_path(source: Path) -> Path:
    """Where ``source`` builds to: keyed on the name and bytes of every
    file in its directory, the source's name and the flags."""
    digest = hashlib.sha256(f"{source.name}\0{' '.join(NVCC_FLAGS)}\0"
                            .encode())
    for path in sorted(source.parent.iterdir()):
        if path.is_file():
            digest.update(f"{path.name}\0{path.stat().st_size}\0".encode())
            digest.update(path.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16] / f"lib{source.stem}.so"


def compile_library(source: Path) -> Path:
    """Compile ``source`` unless its library exists; returns the library.

    The library is written under a temporary name and renamed into place,
    so processes that build the same source at once never load a
    half-written file.  nvcc's report (registers, shared memory, spills)
    is kept beside it as ``build.log``.
    """
    lib = library_path(source)
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
                              capture_output=True, text=True)
        (lib.parent / "build.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source} "
                               f"(exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.lru_cache(maxsize=None)
def load_library(source: Path) -> ctypes.CDLL:
    """Build (at first use) and load ``source``'s shared library."""
    return ctypes.CDLL(str(compile_library(source)))
