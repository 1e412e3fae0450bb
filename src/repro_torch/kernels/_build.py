"""Build the port's CUDA sources at first use and load them with ctypes.

Every ``csrc/*.cu`` file (with the ``*.cuh`` headers it includes)
compiles on its own with ``nvcc`` for ``sm_90a``
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

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

def off_card(*xs) -> bool:
    """Whether a call's tensors (or devices) hold no value on a card: all
    on the CPU (the plain version's inputs) or on the meta device (the dry
    run's shapes, which go through the plain version's arithmetic as
    shapes alone).  A wrapper sends such a call to its plain version."""
    return all((x if isinstance(x, torch.device) else x.device).type
               in ("cpu", "meta") for x in xs)


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
    for p in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
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


def patched(stem: str, patches) -> str:
    """The text of ``csrc/<stem>.cu`` with each ``(old, new)`` of
    ``patches`` replaced; raises when an ``old`` is no longer in it."""
    text = (CSRC / f"{stem}.cu").read_text()
    for old, new in patches:
        if old not in text:
            raise RuntimeError(f"a patch of {stem}.cu no longer matches: "
                               f"{old[:60]!r}")
        text = text.replace(old, new)
    return text


def build_copies(copies, out_dir: Path) -> Dict[str, ctypes.CDLL]:
    """Copies of kernel sources for the timing tools: ``{name: (source
    text, extra nvcc flags)}`` compiled with ``NVCC_FLAGS`` against
    ``csrc/``'s headers into ``out_dir``, one nvcc process a copy, all at
    once, and loaded: ``{name: library}``.  A copy already built from the
    same text and flags loads straight away; a failed build raises with
    nvcc's output."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (text, flags) in copies.items():
        key = hashlib.sha256("\0".join([_digest(), *flags, text]).encode())
        lib = out_dir / f"lib{name}-{key.hexdigest()[:16]}.so"
        proc = None
        if not lib.exists():
            src = out_dir / f"{name}.cu"
            src.write_text(text)
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            proc = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, *flags, "-I", str(CSRC), "-o",
                 str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
                tmp)
        procs[name] = (proc, lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        if proc is not None:
            out, err = proc[0].communicate()
            if proc[0].returncode:
                raise RuntimeError(f"nvcc failed on the copy {name!r} (exit "
                                   f"{proc[0].returncode}):\n{out}{err}")
            os.replace(proc[1], lib)
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry point of ``lib`` returned a CUDA error code."""
    if err != 0:
        fn = lib.cuda_error_string
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(
            f"{what}: CUDA error {err} ({fn(err).decode()}) at launch")
