"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  :func:`build` compiles it
with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``kernels/build/`` (listed in ``.gitignore``), named by a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source is rebuilt and an unchanged one is reused.  :func:`build_many`
starts one ``nvcc`` per source at once.  :func:`load` opens a library with
``ctypes``; the wrapper that calls it declares the ``argtypes``.  Building
happens at first use, never at import: machines without ``nvcc`` import
this package and run the plain PyTorch versions.

Flags: ``NVCC_FLAGS`` for every kernel (``sm_90a`` so that ``wgmma`` and
TMA are available; ``-Xptxas -v`` prints registers, shared memory and
spills), plus ``-fmad=false`` for the kernels in ``EXACT_ROUNDING``.  No
link flag is needed: the flash kernel's TMA maps come from
``cuTensorMapEncodeTiled``, reached at run time through the runtime's
``cudaGetDriverEntryPoint``, so no library links ``libcuda``.  The shared
headers (``common.cuh``, and ``hopper.cuh`` with the PTX wrappers for
mbarriers, TMA tile and bulk copies, ``wgmma``, ``ldmatrix`` and
``mma.sync``) are part of every library's hash.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# -fmad=false: every multiply and add rounds on its own, as in the plain
# PyTorch versions, so the DP kernel agrees with its plain version to the
# bit instead of flipping near-tied argmins where an FMA rounds once, and
# the recurrence's a * h + b rounds as the plain loop's does.  The two
# attention kernels keep FMA contraction: their dot products are summed in
# another order than PyTorch's matmul anyway, so they are held to their
# plain versions by a tolerance, and contraction halves their instruction
# count where operations bound them.
EXACT_ROUNDING = {"dp_recurrence", "rglru_scan"}


def flags(name: str, extra: tuple[str, ...] = ()) -> tuple[str, ...]:
    return (NVCC_FLAGS + (("-fmad=false",) if name in EXACT_ROUNDING else ())
            + tuple(extra))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built at first "
                       "use and need the CUDA toolkit (CUDA_HOME or PATH)")


def library_path(name: str, extra: tuple[str, ...] = ()) -> Path:
    """Where the library built from ``csrc/<name>.cu`` (with the further
    nvcc flags ``extra``, such as ``-D`` settings) lives."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(flags(name, extra)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_many(names, extra: tuple[str, ...] = ()
               ) -> dict[str, tuple[Path, str]]:
    """Compile each ``csrc/<name>.cu`` whose library is not built yet, one
    ``nvcc`` process per source, all started together, each with the
    further flags ``extra``.  Returns, for each name, the library's path and
    the compiler's output ("" when the library was already there)."""
    out, procs = {}, {}
    for name in dict.fromkeys(names):
        path = library_path(name, extra)
        if path.exists():
            out[name] = (path, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *flags(name, extra), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (path, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) for {name}.cu:\n"
                          f"{log}")
            continue
        os.replace(tmp, path)
        out[name] = (path, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def build(name: str, extra: tuple[str, ...] = ()) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` (with the further flags ``extra``) unless
    its library is already built.  Returns the library's path and the
    compiler's output ("" when the library was already there)."""
    return build_many([name], extra)[name]


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it first if
    needed."""
    path, _ = build(name)
    return ctypes.CDLL(str(path))
