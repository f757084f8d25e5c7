"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

``csrc/<name>.cu`` compiles on first use into a shared library with a
plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -shared -Xcompiler -fPIC -o build/<name>-<hash>.so csrc/<name>.cu

The library goes to ``cimba_tpu_torch/build/`` (ignored by git), named
by a hash of every source under ``csrc/`` and the flags, so a checkout
builds its own kernel once and an edited source rebuilds.  A generated
instance of the chunk kernel (a user spec's, :func:`build_gen`) goes to
``build/gen/<hash>/`` with its header.  ``--fmad=false``
keeps the kernel's float arithmetic separately rounded, like the plain
PyTorch engine it is held against.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
ARCH = "arch=compute_90a,code=sm_90a"
FLAGS = ["-gencode", ARCH, "-std=c++17", "-O3", "--fmad=false", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: name -> loaded library (one load per process)
_loaded: dict = {}


def nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str, into=None) -> tuple:
    """Compile ``csrc/<name>.cu`` unless its library for the current
    sources exists (in ``into``, a directory, instead of ``build/`` when
    given).  Returns ``(seconds, ptxas report)``; ``(0.0, "")`` when
    nothing was compiled."""
    out = _target(name)
    if into is not None:
        out = Path(into) / out.name
    if out.exists():
        return 0.0, ""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
    out.with_suffix(".log").write_text(proc.stdout)
    os.replace(tmp, out)
    return time.perf_counter() - t0, proc.stdout


def build_all(names) -> dict:
    """:func:`build` for several sources at once, one ``nvcc`` each, all
    started together.  Returns ``{name: (seconds, ptxas report)}``."""
    names = list(names)
    with ThreadPoolExecutor(max(len(names), 1)) as pool:
        return dict(zip(names, pool.map(build, names)))


def build_gen(header: str) -> tuple:
    """Build a generated instance of the chunk kernel: ``header`` (the
    text :func:`cimba_tpu_torch.core.emit.emit` made) goes to
    ``build/gen/<hash>/gen.cuh``, named by a hash of it, the engine's
    sources and the flags, and ``csrc/queue_chunk.cu`` compiles with it
    alone (``-DCIMBA_GEN_HEADER``, ``-DCIMBA_GEN_ONLY``) into ``gen.so``
    beside it, unless that exists.  Returns ``(library path, seconds,
    ptxas report)``; raises with the header's path when nvcc fails."""
    h = hashlib.sha256(header.encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(FLAGS).encode())
    d = BUILD / "gen" / h.hexdigest()[:16]
    out = d / "gen.so"
    if out.exists():
        return out, 0.0, ""
    d.mkdir(parents=True, exist_ok=True)
    hdr = d / "gen.cuh"
    hdr.write_text(header)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc(), *FLAGS, f'-DCIMBA_GEN_HEADER="{hdr}"', "-DCIMBA_GEN_ONLY",
         "-o", str(tmp), str(CSRC / "queue_chunk.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the generated instance "
                           f"{hdr}:\n{proc.stdout}")
    out.with_suffix(".log").write_text(proc.stdout)
    os.replace(tmp, out)
    return out, time.perf_counter() - t0, proc.stdout


def load_gen(header: str) -> ctypes.CDLL:
    """The generated instance's library for ``header``, built first if
    needed (one load per process and header)."""
    key = ("gen", header)
    lib = _loaded.get(key)
    if lib is None:
        path, _, _ = build_gen(header)
        lib = ctypes.CDLL(str(path))
        _loaded[key] = lib
    return lib


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed.  The sources
    are hashed at the first load only: a launch pays a dict lookup."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(_target(name)))
        _loaded[name] = lib
    return lib
