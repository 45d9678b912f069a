"""Builds the port's CUDA kernels from ``csrc/`` with ``nvcc``, and its
host libraries with the host C++ compiler, at first use.

Each source ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, loaded with ctypes. The library's file name carries a hash of
the sources and flags, so an edited source is rebuilt and a stale library
is never loaded. Importing this module runs nothing; :func:`build` starts
one ``nvcc`` per source, all at once, and waits for them.

A host source ``csrc/<name>.cpp`` (the data pipeline's warps and codecs,
:mod:`.runtime.native`) is compiled by :func:`build_host` with ``g++`` (or
``$CXX``). A compile that fails leaves its compiler output beside the
library's name as ``.failed``; later calls, in this process or another,
read that and do not compile again (delete the file to retry).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("rrdb", "tail", "rrdb_bwd", "tail_bwd", "conv_stack", "conv_stack_wgmma", "conv_f32",
           "conv_frame_tf32")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")
    return found


HOST_FLAGS = ("-O3", "-fPIC", "-shared")


class HostBuildError(RuntimeError):
    """A host library could not be compiled here (no compiler, or a header
    or library it needs is missing)."""


def host_compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise HostBuildError("no host C++ compiler (g++, c++ or $CXX) on this machine")
    return cxx


def host_lib_path(name: str, libs: Tuple[str, ...] = ()) -> Path:
    """Where ``csrc/<name>.cpp`` built with ``libs`` lives: the name hashes
    the source and the flags."""
    h = hashlib.sha1(" ".join(HOST_FLAGS + tuple(libs)).encode())
    h.update((CSRC / f"{name}.cpp").read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_host(name: str, libs: Tuple[str, ...] = ()) -> Path:
    """The library of ``csrc/<name>.cpp`` linked with ``libs`` (``-l``
    flags), compiled now if it is not built yet. Raises
    :class:`HostBuildError` when the compile fails, now or in an earlier
    call (the ``.failed`` file beside it holds the compiler's output)."""
    target = host_lib_path(name, libs)
    failed = target.with_suffix(".failed")
    if target.exists():
        return target
    if failed.exists():
        raise HostBuildError(f"{name}: an earlier compile failed ({failed}):\n{failed.read_text()}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
    cmd = [host_compiler(), *HOST_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cpp"), *libs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        failed.write_text(f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        raise HostBuildError(f"{name}: compile failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)
    return target


def _lib_path(name: str, defines: Tuple[str, ...] = ()) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS + tuple(defines)).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(
    names: Iterable[str] = SOURCES, variants: Iterable[Tuple[str, Tuple[str, ...]]] = ()
) -> Dict[str, Tuple[float, str]]:
    """Compiles each named source, and each ``(name, extra -D flags)`` of
    ``variants``, that has no up-to-date library, all in parallel. Returns
    ``{label: (seconds, nvcc stderr)}`` for the libraries it compiled
    (``-Xptxas -v`` puts registers, shared memory and spills there). Raises
    if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name, defines in [(n, ()) for n in names] + [(n, tuple(d)) for n, d in variants]:
        target = _lib_path(name, defines)
        if target.exists():
            continue
        tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, *defines, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[" ".join((name,) + defines)] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
            tmp, target, time.perf_counter(),
        )
    report, failed = {}, []
    for name, (proc, tmp, target, t0) in procs.items():
        out, err = proc.communicate()
        report[name] = (time.perf_counter() - t0, out + err)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{out}{err}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (compiled with the extra
    ``defines``), building it if needed."""
    key = " ".join((name,) + tuple(defines))
    lib = _loaded.get(key)
    if lib is None:
        path = _lib_path(name, tuple(defines))
        if not path.exists():
            build([], [(name, tuple(defines))])
        lib = ctypes.CDLL(str(path))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _loaded[key] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raises with CUDA's message when a launcher returned an error code."""
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {rc} ({msg})")
