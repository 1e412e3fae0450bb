"""Build the port's CUDA sources at first use and load them with ctypes.

Every ``csrc/*.cu`` file compiles on its own with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, all sources at once in
parallel.  Libraries land in ``build/repro_torch_kernels/`` at the root of
the checkout, named by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads straight away.  A failed build raises
with nvcc's own output; there is no fallback.

Nothing here runs at import: the CPU path never needs a compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# Seconds spent compiling (0 when every library was already built) and
# ptxas's register / shared-memory report per source, for the chip log.
build_seconds = 0.0
ptxas_report: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build_all() -> None:
    """Compile every missing library, one nvcc process per source, together."""
    global build_seconds
    digest = _digest()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {}
    for src in sorted(CSRC.glob("*.cu")):
        out = BUILD_DIR / f"lib{src.stem}-{digest}.so"
        if not out.exists():
            todo[src.stem] = (src, out)
    if not todo:
        return
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for stem, (src, out) in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, out)
    errors = []
    for stem, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"--- {stem}.cu (exit {proc.returncode}) ---\n"
                          f"{stdout}{stderr}")
            continue
        ptxas_report[stem] = stderr
        os.replace(tmp, out)
    build_seconds += time.perf_counter() - t0
    if errors:
        raise RuntimeError("nvcc failed to build the CUDA kernels:\n"
                           + "\n".join(errors))


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built on first use)."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            _build_all()
            lib = ctypes.CDLL(str(BUILD_DIR / f"lib{stem}-{_digest()}.so"))
            _libs[stem] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry point of ``lib`` returned a CUDA error code."""
    if err != 0:
        fn = lib.cuda_error_string
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(
            f"{what}: CUDA error {err} ({fn(err).decode()}) at launch")
