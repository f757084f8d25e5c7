"""The generated chunk kernel built with g++ and run on the CPU.

``csrc/queue_chunk.cu`` with a generated header (``core/emit.py``) is a
CUDA source, but apart from its launch and a handful of intrinsics it is
plain C++17.  This module builds it for the host, so a generated
instance (or a redesign of the engine) can be held against the plain
engine (``loop.make_run``) without a card:

* a stand-in for ``cuda_runtime.h`` (:data:`SHIM_H`): ``__device__``,
  ``__global__``, ``__host__``, ``__forceinline__``,
  ``__launch_bounds__(...)`` and ``__grid_constant__`` defined away,
  ``__align__(n)`` as ``alignas(n)``, ``__shared__`` as ``static``,
  ``threadIdx``/``blockIdx``/``blockDim`` thread-local globals, the
  runtime calls the launcher makes (``cudaFuncSetAttribute``,
  ``cudaGetLastError``, ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)
  as stubs, and the intrinsics the engine's headers call as host code,
  each exact: the bit casts, ``__fma_rn``/``__fmaf_rn`` as ``fma``, the
  ``_rn`` conversions by round-to-nearest-even, ``__umul64hi`` through a
  128-bit product, ``__clzll``, and ``__ffs``, ``__ffsll``, ``__popc``,
  ``__popcll`` as the compiler's builtins (1-based lowest set bit, 0 for
  no bit; the count of set bits);
* the source rewritten (:func:`rewrite`): each launch ``chunk_kernel<...>
  <<<grid, threads, smem, stream>>>(args);`` into ``shim_launch(grid,
  threads, smem, stream, [&] { chunk_kernel<...>(args); });``, which runs
  the grid's threads one after another (the generated family's lanes
  share nothing but their own shared-memory columns), and the dynamic
  shared memory ``extern __shared__ ... dyn_smem[];`` into a pointer to
  a zeroed buffer the launch allocates;
* ``g++ -std=c++17 -O1 -ffp-contract=off -fno-gnu-unique -shared -fPIC``
  (separately rounded float operations, as ``nvcc --fmad=false``; no GNU
  unique symbols, or the ``static`` columns of two instances loaded in
  one process would be one object) into ``build/shim/<hash>/``.

Floats differ from the plain engine's where glibc's ``log1p``, ``exp``,
``sin`` or ``cos`` differ from torch's in the last place; integers never.

Usage::

    from cimba_tpu_torch.tools import gxx_shim
    lay = kernel_run.generated_kernel_for(spec, sims)[0]
    lib = gxx_shim.build(lay["header"])
    gxx_shim.chunk(lib, sims, lay, 64)        # in place, CPU tensors
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

from cimba_tpu_torch import _build, tree

#: the stand-in for cuda_runtime.h
SHIM_H = r"""
#pragma once
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __grid_constant__
#define __align__(n) alignas(n)
#define __shared__ static

struct shim_dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local shim_dim3 threadIdx, blockIdx, blockDim;

typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
template <class F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* n, F, int, size_t) {
  *n = 1;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

inline thread_local unsigned char* shim_dyn_smem = nullptr;

// the grid's blocks and each block's threads, one after another
template <class F>
inline void shim_launch(int grid, int threads, int smem, cudaStream_t,
                        F&& f) {
  std::vector<unsigned char> buf(size_t(smem > 0 ? smem : 0) + 64, 0);
  shim_dyn_smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(buf.data()) + 63) & ~uintptr_t(63));
  blockDim.x = threads;
  for (int b = 0; b < grid; ++b) {
    blockIdx.x = b;
    for (int t = 0; t < threads; ++t) {
      threadIdx.x = t;
      f();
    }
  }
}

inline double __longlong_as_double(long long x) {
  double d; std::memcpy(&d, &x, 8); return d;
}
inline long long __double_as_longlong(double x) {
  long long d; std::memcpy(&d, &x, 8); return d;
}
inline float __int_as_float(int x) { float f; std::memcpy(&f, &x, 4); return f; }
inline unsigned __float_as_uint(float x) {
  unsigned u; std::memcpy(&u, &x, 4); return u;
}
inline double __fma_rn(double a, double b, double c) { return std::fma(a, b, c); }
inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
inline double __dmul_rn(double a, double b) { return a * b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline double __ll2double_rn(long long x) { return double(x); }
inline float __int2float_rn(int x) { return float(x); }
inline double __int2double_rn(int x) { return double(x); }
inline int __float2int_rn(float x) { return int(std::nearbyint(x)); }
inline int __double2int_rn(double x) { return int(std::nearbyint(x)); }
inline float __double2float_rn(double x) { return float(x); }
inline unsigned long long __umul64hi(unsigned long long a,
                                     unsigned long long b) {
  return (unsigned long long)(((unsigned __int128)a * b) >> 64);
}
inline int __clzll(long long x) {
  return x == 0 ? 64 : __builtin_clzll((unsigned long long)x);
}
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __ffsll(long long x) { return __builtin_ffsll(x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __popcll(unsigned long long x) { return __builtin_popcountll(x); }
using std::isinf;
using std::isnan;
"""

FLAGS = ["-std=c++17", "-O1", "-ffp-contract=off", "-fno-gnu-unique",
         "-shared", "-fPIC", "-w"]
OUT = _build.BUILD / "shim"

_LAUNCH = re.compile(r"chunk_kernel<([^;]*?)><<<(.*?)>>>\((.*?)\);", re.S)
_DYN = re.compile(r"extern __shared__[^;]*?dyn_smem\[\];")


def available() -> bool:
    """Whether a g++ is on PATH."""
    return shutil.which("g++") is not None


def rewrite(src: str) -> str:
    """``queue_chunk.cu`` (or a variant) with its launches and dynamic
    shared memory rewritten for the host."""
    src = _LAUNCH.sub(lambda m: (f"shim_launch({m.group(2)}, [&] {{ "
                                 f"chunk_kernel<{m.group(1)}>({m.group(3)}); "
                                 "});"), src)
    return _DYN.sub("unsigned char* dyn_smem = shim_dyn_smem;", src)


def build(header: str, source: Optional[str] = None,
          opt: str = "-O1") -> Path:
    """The host library of the generated instance ``header`` built from
    ``source`` (the text of a ``queue_chunk.cu``; this checkout's by
    default), with its headers from ``csrc/``; built once per content
    into ``build/shim/<hash>/lib.so``.  Raises with g++'s output where it
    fails."""
    if source is None:
        source = (_build.CSRC / "queue_chunk.cu").read_text()
    flags = [f for f in FLAGS if not f.startswith("-O")] + [opt]
    h = hashlib.sha256()
    for part in (SHIM_H, header, source, " ".join(flags)):
        h.update(part.encode())
    for src in sorted(_build.CSRC.glob("*.cuh")):
        h.update(src.read_bytes())
    d = OUT / h.hexdigest()[:16]
    lib = d / "lib.so"
    if lib.exists():
        return lib
    d.mkdir(parents=True, exist_ok=True)
    (d / "cuda_runtime.h").write_text(SHIM_H)
    (d / "gen.cuh").write_text(header)
    cc = d / "queue_chunk.cc"
    cc.write_text(rewrite(source))
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        ["g++", *flags, "-I", str(d), "-I", str(_build.CSRC),
         f'-DCIMBA_GEN_HEADER="{d / "gen.cuh"}"', "-DCIMBA_GEN_ONLY",
         "-o", str(tmp), str(cc)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {cc}:\n{proc.stdout[-4000:]}")
    os.replace(tmp, lib)
    return lib


def load(path) -> ctypes.CDLL:
    return ctypes.CDLL(str(path))


def chunk(lib: ctypes.CDLL, sims, lay: dict, chunk_steps: int,
          t_end: Optional[float] = None):
    """One chunk of the host-built instance ``lib`` on a lane-first Sim of
    CPU tensors, IN PLACE, as ``kernel_run.gen_chunk`` launches it on the
    card; returns ``sims``."""
    from cimba_tpu_torch.core import kernel_run

    leaves = tree.leaves(sims)
    if leaves[0].is_cuda:
        raise ValueError("the host-built instance takes a Sim on the CPU")
    real, count = sims.clock.dtype, sims.n_events.dtype
    lanes = kernel_run._check_leaves(leaves, lay["table"], lay, real, count)
    args = kernel_run._chunk_args((lay["E"], lay["W"]), chunk_steps, t_end)
    fn = getattr(lib, "cimba_gen_chunk_"
                      f"{'f32' if real == torch.float32 else 'f64'}")
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                   + [t for t, _ in args] + [ctypes.c_void_p])
    ptrs = (ctypes.c_void_p * len(leaves))(*[x.data_ptr() for x in leaves])
    rc = fn(ptrs, len(leaves), lanes, *[v for _, v in args], None)
    if rc != 0:
        raise RuntimeError(f"cimba_gen_chunk: launch refused (code {rc})")
    return sims
