"""Build and load the port's CUDA C++ kernels.

No JAX counterpart: JAX compiles the Pallas kernels itself. Here each
`csrc/<name>.cu` is compiled by `nvcc` into a shared library with a plain C
interface and loaded with `ctypes`. The build happens at first use, never
at import, into `_build/` beside the package. The library's file name
carries a hash of the sources and the flags, so an edited source builds
again; an existing library is reused. Compiler output (with `-Xptxas -v`:
registers, shared memory and spills per kernel) is kept beside the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

__all__ = ["NVCC_FLAGS", "find_nvcc", "build_library", "build_libraries",
           "load_library", "build_log"]

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_PACKAGE = Path(__file__).resolve().parent.parent
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "_build"

_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME/bin (or $CUDA_PATH/bin, or the
    toolkit's default prefix); raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    roots = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
             "/usr/local/cuda"]
    for root in roots:
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: building the CUDA "
        "kernels needs the CUDA toolkit")


def _library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_library(name: str) -> Path:
    """Compile csrc/<name>.cu unless a library of the same sources exists."""
    return build_libraries([name])[name]


def build_libraries(names) -> Dict[str, Path]:
    """Compile every csrc/<name>.cu not built yet, one nvcc process each, all
    started together; raises if any fails."""
    outs = {name: _library_path(name) for name in names}
    procs = {}
    for name, out in outs.items():
        if out.is_file():
            continue
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (cmd, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
            continue
        outs[name].with_suffix(".log").write_text(log)
        os.replace(tmp, outs[name])  # atomic: a concurrent build never loads a half file
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def build_log(name: str) -> str:
    """The compiler's output for the current build of `name`."""
    log = _library_path(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu once per process."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_library(name)))
        _loaded[name] = lib
    return lib
