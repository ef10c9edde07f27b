"""Build and load the port's hand-written CUDA kernels, and its host C++
library.

Each kernel source in ``pointunet_tpu_torch/csrc/`` exports a plain C
launch function. ``build_all(sources)`` compiles sources in parallel (one
``nvcc`` each); ``load(source, symbol, argtypes)`` compiles the source
with ``nvcc`` for ``sm_90a`` at first use into ``pointunet_tpu_torch/_build/``
(ignored by git), under a name keyed on a hash of the source, keeps the
compiler's ``-Xptxas -v`` report (registers, spills) beside the library as
``.log``, loads it with ctypes and returns the typed launch function.
Each source is one translation unit with no headers of its own, so the
hash of the source covers everything a build reads from the repo.
Nothing is built when a module is imported: the CPU tests import every
module and have no ``nvcc``. ``build_host(source)`` compiles a host C++
source (``csrc/pointops.cpp``, for ``native.py``) the same way, with
``$CXX`` or ``g++`` and the flags of the reference's ``csrc/Makefile``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

_loaded: Dict[Path, ctypes.CDLL] = {}


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH); the CUDA "
            "kernels are built from source at first use"
        )
    return found


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}_{digest}.so"


def build_all(sources: Sequence[Path],
              seconds: Optional[Dict[str, float]] = None) -> List[Path]:
    """Compile each source whose hash has no library yet, one ``nvcc``
    per source, all started together; the libraries' paths. ``seconds``,
    when given, receives the wall seconds of each compiled source's
    ``nvcc`` by file name."""
    jobs = []
    for source in sources:
        so = library_path(source)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [
            nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", str(tmp), str(source),
        ]
        log = open(so.with_suffix(".log"), "w")
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
        jobs.append((source, so, tmp, proc, log, time.perf_counter()))
    failed = []
    pending = list(jobs)
    while pending:                     # each job's seconds as it ends
        for job in list(pending):
            source, so, tmp, proc, log, t0 = job
            if proc.poll() is None:
                continue
            pending.remove(job)
            if seconds is not None:
                seconds[source.name] = time.perf_counter() - t0
            log.close()
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {source.name} "
                              f"({proc.returncode}):\n"
                              f"{so.with_suffix('.log').read_text()}")
            else:
                os.replace(tmp, so)
        time.sleep(0.05)
    if failed:
        raise RuntimeError("\n".join(failed))
    return [library_path(s) for s in sources]


def load(source: Path, symbol: str, argtypes: Sequence) -> ctypes.CDLL:
    """Build (once per source hash) and load ``source``'s library, with
    ``symbol`` typed as ``int symbol(*argtypes)``."""
    lib = _loaded.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([source])[0]))
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _loaded[source] = lib
    return lib


def cxx() -> Optional[str]:
    """The host C++ compiler, ``$CXX`` or ``g++`` on PATH; None if absent."""
    return shutil.which(os.environ.get("CXX") or "g++")


HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")


def host_library_path(source: Path, compiler: str,
                      flags: Sequence[str]) -> Path:
    """Where ``build_host`` puts ``source`` built by ``compiler`` with
    ``flags``."""
    key = hashlib.sha256(
        source.read_bytes() + "\0".join((compiler, *flags)).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}_{key}.so"


def build_host(source: Path) -> Path:
    """Compile the host C++ ``source`` into a shared library with the
    flags of the reference's ``csrc/Makefile`` (``-O3 -std=c++17 -fPIC
    -fopenmp``), or without ``-fopenmp`` where that build fails or does
    not load (a compiler or host with no OpenMP runtime; the source
    guards its pragmas with ``_OPENMP`` and runs on one thread). The
    library's name is keyed on the source, the compiler's path and the
    flags, and a library already there is used only if it loads. Its
    path; raises when there is no compiler or no build loads."""
    compiler = cxx()
    if compiler is None:
        raise RuntimeError(
            "no C++ compiler ($CXX or g++ on PATH) to build "
            f"{source.name}"
        )
    errors = []
    for openmp in (("-fopenmp",), ()):
        flags = HOST_FLAGS + openmp
        so = host_library_path(source, compiler, flags)
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
            proc = subprocess.run(
                [compiler, *flags, "-o", str(tmp), str(source)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                errors.append(f"{compiler} {' '.join(flags)} failed on "
                              f"{source.name} ({proc.returncode}):\n"
                              f"{proc.stdout}{proc.stderr}")
                continue
            os.replace(tmp, so)
        try:
            ctypes.CDLL(str(so))
        except OSError as e:
            errors.append(f"{so.name} does not load: {e}")
            continue
        return so
    raise RuntimeError("\n".join(errors))
