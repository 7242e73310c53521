"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
``build/<name>-<hash>.so``, where the hash covers every source and header
under ``csrc/`` and the compiler flags: a changed source is rebuilt, an
unchanged one is loaded as it is. All missing libraries are compiled at once,
one ``nvcc`` process per source. A failed build raises with the compiler's
output; nothing falls back. nvcc's output, including ``-Xptxas -v``'s
register and spill counts, is kept beside each library as ``<name>-<hash>.log``.

Host C++ sources, ``csrc/<name>.cpp`` (the native batch assembly), are
built the same way by ``host_library`` with ``g++`` (``HOST_FLAGS``), the
hash covering the source and the flags, at their first use.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD = PACKAGE / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")

HOST_FLAGS = ("-O3", "-fPIC", "-pthread", "-shared", "-std=c++17")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "toolkit is needed to build the port's kernels")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _target(source: Path) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(source.read_bytes())
    return BUILD / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every kernel library not yet built; return name -> path."""
    targets = {src.stem: (src, _target(src)) for src in _sources()}
    missing = {name: st for name, st in targets.items() if not st[1].exists()}
    if missing:
        BUILD.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        jobs = []
        for name, (src, out) in missing.items():
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            log = out.with_suffix(".log")
            with open(log, "w") as fh:
                proc = subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                    stdout=fh, stderr=subprocess.STDOUT)
            jobs.append((name, proc, tmp, out, log))
        failed = []
        for name, proc, tmp, out, log in jobs:
            if proc.wait() != 0:
                failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n"
                              f"{log.read_text()}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return {name: out for name, (_, out) in targets.items()}


def build_log(name: str) -> str:
    """nvcc's output for ``csrc/<name>.cu`` (ptxas register/spill lines)."""
    return _target(CSRC / f"{name}.cu").with_suffix(".log").read_text()


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded shared library for ``csrc/<name>.cu``, built if needed."""
    return ctypes.CDLL(str(build_all()[name]))


def _host_target(source: Path) -> Path:
    digest = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    digest.update(source.read_bytes())
    return BUILD / f"{source.stem}-{digest.hexdigest()[:16]}.so"


@functools.cache
def host_library(name: str) -> ctypes.CDLL:
    """The loaded shared library of the host C++ source ``csrc/<name>.cpp``,
    compiled with g++ first where it is not built; a failed build raises
    with the compiler's output."""
    src = CSRC / f"{name}.cpp"
    out = _host_target(src)
    if not out.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        log = out.with_suffix(".log")
        with open(log, "w") as fh:
            rc = subprocess.call(["g++", *HOST_FLAGS, "-o", str(tmp), str(src)],
                                 stdout=fh, stderr=subprocess.STDOUT)
        if rc != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"host build of {name}.cpp failed (exit {rc}):"
                               f"\n{log.read_text()}")
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))
