"""Build the port's CUDA sources (``csrc/*.cu``) and load them with ctypes.

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, into ``build/`` beside this file
(listed in ``.gitignore``). The library name carries a hash of the source
and the flags, so an edited source is rebuilt and a stale one never loads.
``build`` starts one ``nvcc`` per source, all at once, and waits for all,
holding an exclusive ``flock`` on ``build/.lock`` meanwhile: processes that
load at once (the ranks of a sharded search) wait for one build and then
find its library there. The kernel drops the lock with its holder, so a
killed build leaves nothing to clear.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD = Path(__file__).resolve().with_name("build")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return path


def library_path(source: str) -> Path:
    src = CSRC / source
    digest = hashlib.sha1(src.read_bytes() + " ".join(FLAGS).encode())
    return BUILD / f"lib{src.stem}-{digest.hexdigest()[:12]}.so"


def build(sources) -> dict[str, str]:
    """Compile every source whose library is missing, one ``nvcc`` each,
    all started together. Returns {source: compiler output} for the
    sources compiled now; raises after all finish if any failed."""
    BUILD.mkdir(exist_ok=True)
    with open(BUILD / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return _build_locked(sources)


def _build_locked(sources) -> dict[str, str]:
    started = {}
    for source in sources:
        out = library_path(source)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / source)]
        started[source] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, out)
    logs, failed = {}, []
    for source, (proc, tmp, out) in started.items():
        logs[source], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(source)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {s}\n{logs[s]}" for s in failed))
    return logs


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    if source not in _LIBS:
        build([source])
        _LIBS[source] = ctypes.CDLL(str(library_path(source)))
    return _LIBS[source]
