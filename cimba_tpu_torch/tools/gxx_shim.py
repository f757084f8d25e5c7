"""The generated chunk kernel and the bulk samplers built with g++ and run
on the CPU.

``csrc/queue_chunk.cu`` with a generated header (``core/emit.py``) is a
CUDA source, but apart from its launch and a handful of intrinsics it is
plain C++17.  This module builds it for the host, so a generated
instance (or a redesign of the engine) can be held against the plain
engine (``loop.make_run``) without a card; and ``csrc/bulk_samplers.cu``
(:func:`build_samplers`, :func:`block`), so K2-K4 can be held against
their plain versions (``random/block_kernels.py``):

* a stand-in for ``cuda_runtime.h`` (:data:`SHIM_H`): ``__device__``,
  ``__global__``, ``__host__``, ``__forceinline__``,
  ``__launch_bounds__(...)`` and ``__grid_constant__`` defined away,
  ``__align__(n)`` as ``alignas(n)``, ``__shared__`` as ``static``,
  ``threadIdx``/``blockIdx``/``blockDim``/``gridDim`` thread-local
  globals, ``float4``/``double2`` and their ``make_*``, the runtime calls
  the launchers make (``cudaFuncSetAttribute``, ``cudaGetLastError``,
  ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` (1 block),
  ``cudaGetDevice``, ``cudaDeviceGetAttribute`` (``SHIM_SMS`` SMs)) as
  stubs, the warp intrinsics (``__activemask``, ``__ballot_sync``,
  ``__any_sync``, ``__all_sync``, ``__syncwarp``, ``__shfl_sync``,
  ``__shfl_xor_sync``) in two forms: in a kernel launched by
  ``shim_launch`` each thread runs as a warp of one lane (a vote is its
  own predicate, a ballot its own bit, a shuffle its own value; exact in
  value where, as in K3's vote, a vote only picks between paths that
  compute the same value; code that moves values between the lanes of a
  whole warp, as K2's and K3's f64 ``log1p_run`` does, never runs there),
  and in one launched by ``shim_launch_block`` (below) a warp's 32
  threads exchange their values as on the card, each warp call a turn
  of the block's fibers (K4's ballots and queue, the peek's shuffles);
  and the
  intrinsics the engine's headers call as host code,
  each exact: the bit casts, ``__fma_rn``/``__fmaf_rn`` as ``fma``, the
  ``_rn`` conversions by round-to-nearest-even, ``__umul64hi`` through a
  128-bit product, ``__clzll``, and ``__ffs``, ``__ffsll``, ``__popc``,
  ``__popcll`` as the compiler's builtins (1-based lowest set bit, 0 for
  no bit; the count of set bits);
* the source rewritten (:func:`rewrite`): each launch ``name_kernel<...>
  <<<grid, threads, smem, stream>>>(args);`` (or one without template
  arguments) into ``shim_launch(grid, threads, smem, stream, [&] {
  name_kernel<...>(args); });``, which runs
  the grid's threads one after another (the generated family's lanes
  share nothing but their own shared-memory columns; nor do K2's and
  K3's), or, for a kernel whose threads meet at ``__syncthreads()`` or
  in warp calls (K4 loads its tables behind one and gathers its misses
  by ballots; the peek's groups shuffle), ``shim_launch_block``, which
  runs each block's threads as fibers (``ucontext``) that take turns:
  one runs at a time, and a ``__syncthreads()`` or a warp call hands the
  turn on until all have reached it;
  and the dynamic shared memory ``extern __shared__ ... dyn_smem[];``
  into a pointer to a zeroed buffer the launch allocates (one for the
  grid: its blocks run one after another);
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
    lib = gxx_shim.load(gxx_shim.build_samplers())
    states, x = gxx_shim.block(lib, "normal_block", states, n)
    lib = gxx_shim.load(gxx_shim.build_bisect())
    event = gxx_shim.peek(lib, sims, table, lay)   # K6's peek
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
#include <ucontext.h>

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
inline thread_local shim_dim3 threadIdx, blockIdx, blockDim, gridDim;

struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct alignas(16) double2 { double x, y; };
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
inline double2 make_double2(double x, double y) { return {x, y}; }

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
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
constexpr int SHIM_SMS = 3;
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = SHIM_SMS;
  return cudaSuccess;
}

inline thread_local unsigned char* shim_dyn_smem = nullptr;

// the grid's blocks and each block's threads, one after another
template <class F>
inline void shim_launch(int grid, int threads, int smem, cudaStream_t,
                        F&& f) {
  std::vector<unsigned char> buf(size_t(smem > 0 ? smem : 0) + 64, 0);
  shim_dyn_smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(buf.data()) + 63) & ~uintptr_t(63));
  blockDim.x = threads;
  gridDim.x = grid;
  for (int b = 0; b < grid; ++b) {
    blockIdx.x = b;
    for (int t = 0; t < threads; ++t) {
      threadIdx.x = t;
      f();
    }
  }
}

// the threads of a block launched by shim_launch_block are fibers
// (ucontext) of the launching thread that take turns: one runs until it
// ends or reaches __syncthreads() or a warp call, which hands the turn
// to the next (round the block, so all have reached it when the turn
// comes back).  A warp call leaves the lane's value under the call's
// number (its count of warp calls), by the number's parity: when the
// turn comes back every lane still running has left its value of the
// same call, and none has yet overwritten the one before
struct shim_fibers {
  ucontext_t sched;
  std::vector<ucontext_t> ctx;
  std::vector<char> done;
  std::vector<unsigned> calls;
  std::vector<unsigned long long> xval[2];
  std::vector<unsigned> xtag[2];
  int cur = 0, threads = 0;
  void (*run)(void*) = nullptr;
  void* arg = nullptr;
};
inline thread_local shim_fibers* shim_block = nullptr;

inline void shim_yield() {
  swapcontext(&shim_block->ctx[shim_block->cur], &shim_block->sched);
}

inline void __syncthreads() {
  if (shim_block == nullptr) return;  // shim_launch: one thread at a time
  shim_yield();
}

// a warp call of a fiber: the values of this call of the warp's lanes
// (bit l of the result: lane l made it)
inline unsigned shim_warp_call(unsigned long long v,
                               unsigned long long (&lanes)[32]) {
  shim_fibers& b = *shim_block;
  const int t = b.cur;
  const unsigned c = b.calls[t]++;
  b.xval[c & 1][t] = v;
  b.xtag[c & 1][t] = c;
  shim_yield();
  unsigned have = 0;
  const int base = t & ~31;
  for (int l = 0; l < 32 && base + l < b.threads; ++l) {
    if (b.xtag[c & 1][base + l] == c) {
      lanes[l] = b.xval[c & 1][base + l];
      have |= 1u << l;
    }
  }
  return have;
}

template <class T>
inline unsigned long long shim_bits(T v) {
  unsigned long long u = 0;
  std::memcpy(&u, &v, sizeof(T));
  return u;
}

template <class T>
inline T shim_from_bits(unsigned long long u) {
  T v;
  std::memcpy(&v, &u, sizeof(T));
  return v;
}

// the warp intrinsics.  Launched by shim_launch, each thread runs as a
// warp of its own: a vote is the lane's own predicate, a ballot its own
// bit, a shuffle its own value, and no warp is ever whole, so code that
// moves values between the lanes of a whole warp never runs there.
// Launched by shim_launch_block, a warp's 32 fibers exchange their
// values as the card's lanes do (shim_warp_call)
inline unsigned __activemask() {
  if (shim_block == nullptr) return 1u << (threadIdx.x & 31u);
  unsigned m = 0;
  const int base = int(threadIdx.x) & ~31;
  for (int l = 0; l < 32 && base + l < shim_block->threads; ++l)
    if (!shim_block->done[base + l]) m |= 1u << l;
  return m;
}
inline unsigned __ballot_sync(unsigned mask, int p) {
  if (shim_block == nullptr) return p ? mask & (1u << (threadIdx.x & 31u)) : 0u;
  unsigned long long v[32];
  const unsigned have = shim_warp_call(p != 0, v);
  unsigned r = 0;
  for (int l = 0; l < 32; ++l)
    if ((have >> l & 1u) && v[l]) r |= 1u << l;
  return r & mask;
}
inline int __any_sync(unsigned mask, int p) {
  return __ballot_sync(mask, p) != 0;
}
inline int __all_sync(unsigned mask, int p) {
  if (shim_block == nullptr) return p;
  unsigned long long v[32];
  const unsigned have = shim_warp_call(p != 0, v) & mask;
  for (int l = 0; l < 32; ++l)
    if ((have >> l & 1u) && !v[l]) return 0;
  return 1;
}
inline void __syncwarp(unsigned = 0xffffffffu) {
  if (shim_block == nullptr) return;
  unsigned long long v[32];
  shim_warp_call(0, v);
}
template <class T>
inline T __shfl_sync(unsigned, T v, int src) {
  if (shim_block == nullptr) return v;
  unsigned long long x[32];
  const unsigned have = shim_warp_call(shim_bits(v), x);
  return (have >> (src & 31) & 1u) ? shim_from_bits<T>(x[src & 31]) : v;
}
template <class T>
inline T __shfl_xor_sync(unsigned mask, T v, int m) {
  return __shfl_sync(mask, v, int(threadIdx.x & 31u) ^ m);
}

inline void shim_fiber_main() {
  shim_block->run(shim_block->arg);
  shim_block->done[shim_block->cur] = 1;
}

template <class F>
inline void shim_launch_block(int grid, int threads, int smem, cudaStream_t,
                              F&& f) {
  std::vector<unsigned char> buf(size_t(smem > 0 ? smem : 0) + 64, 0);
  shim_dyn_smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(buf.data()) + 63) & ~uintptr_t(63));
  constexpr size_t stack = size_t(1) << 16;
  std::vector<char> stacks(stack * size_t(threads));
  shim_fibers fb;
  fb.ctx.resize(threads);
  fb.threads = threads;
  fb.run = [](void* p) { (*static_cast<F*>(p))(); };
  fb.arg = &f;
  shim_block = &fb;
  blockDim.x = threads;
  gridDim.x = grid;
  for (int b = 0; b < grid; ++b) {
    blockIdx.x = b;
    fb.done.assign(threads, 0);
    fb.calls.assign(threads, 0);
    for (int k = 0; k < 2; ++k) {
      fb.xval[k].assign(threads, 0);
      fb.xtag[k].assign(threads, ~0u);
    }
    for (int t = 0; t < threads; ++t) {
      getcontext(&fb.ctx[t]);
      fb.ctx[t].uc_stack.ss_sp = stacks.data() + stack * size_t(t);
      fb.ctx[t].uc_stack.ss_size = stack;
      fb.ctx[t].uc_link = &fb.sched;
      makecontext(&fb.ctx[t], shim_fiber_main, 0);
    }
    for (bool left = true; left;) {
      left = false;
      for (int t = 0; t < threads; ++t) {
        if (fb.done[t]) continue;
        fb.cur = t;
        threadIdx.x = t;
        swapcontext(&fb.sched, &fb.ctx[t]);
        left = left || !fb.done[t];
      }
    }
  }
  shim_block = nullptr;
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

# a launch `name_kernel<targs><<<cfg>>>(args);` (targs hold no parenthesis,
# so a mention of the kernel earlier in a statement is not taken for it)
_LAUNCH = re.compile(
    r"\b(\w+_kernel)(?:<([^;(){}]*?)>)?<<<(.*?)>>>\((.*?)\);", re.S)
_DYN = re.compile(r"extern __shared__[^;]*?dyn_smem\[\];")


def available() -> bool:
    """Whether a g++ is on PATH."""
    return shutil.which("g++") is not None


def rewrite(src: str, blocking=()) -> str:
    """A kernel source (``queue_chunk.cu``, ``bulk_samplers.cu``, or a
    variant) with its launches and dynamic shared memory rewritten for
    the host; the kernels named in ``blocking`` launch through
    ``shim_launch_block`` (their threads meet at ``__syncthreads()``)."""
    def launch(m):
        name, targs, cfg, args = m.groups()
        how = "shim_launch_block" if name in blocking else "shim_launch"
        kernel = name if targs is None else f"{name}<{targs}>"
        return f"{how}({cfg}, [&] {{ {kernel}({args}); }});"

    src = _LAUNCH.sub(launch, src)
    return _DYN.sub("unsigned char* dyn_smem = shim_dyn_smem;", src)


def _compile(cc_name: str, text: str, flags: list, files: dict = {},
             defines: tuple = ()) -> Path:
    """g++ of the rewritten source ``text`` (saved as ``cc_name``) with
    the shim's ``cuda_runtime.h``, ``files`` (name: text) beside it and
    the headers of ``csrc/``, into ``build/shim/<hash>/lib.so``, once per
    content.  Raises with g++'s output where it fails."""
    h = hashlib.sha256()
    for part in (SHIM_H, text, " ".join(flags), *files.values(), *defines):
        h.update(part.encode())
    for src in sorted(_build.CSRC.glob("*.cuh")):
        h.update(src.read_bytes())
    d = OUT / h.hexdigest()[:16]
    lib = d / "lib.so"
    if lib.exists():
        return lib
    d.mkdir(parents=True, exist_ok=True)
    (d / "cuda_runtime.h").write_text(SHIM_H)
    for name, body in files.items():
        (d / name).write_text(body)
    cc = d / cc_name
    cc.write_text(text)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        ["g++", *flags, "-I", str(d), "-I", str(_build.CSRC),
         *[x.replace("{dir}", str(d)) for x in defines], "-o", str(tmp),
         str(cc)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {cc}:\n{proc.stdout[-4000:]}")
    os.replace(tmp, lib)
    return lib


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
    return _compile("queue_chunk.cc", rewrite(source), flags,
                    {"gen.cuh": header},
                    ('-DCIMBA_GEN_HEADER="{dir}/gen.cuh"', "-DCIMBA_GEN_ONLY"))


def build_samplers(source: Optional[str] = None, opt: str = "-O1") -> Path:
    """The host library of ``csrc/bulk_samplers.cu`` (or of ``source``,
    the text of another version of it), K4's blocks launched as fibers
    that take turns; built once per content into
    ``build/shim/<hash>/lib.so``."""
    if source is None:
        source = (_build.CSRC / "bulk_samplers.cu").read_text()
    flags = [f for f in FLAGS if not f.startswith("-O")] + [
        opt, "-fno-strict-aliasing"]
    return _compile("bulk_samplers.cc",
                    rewrite(source, blocking=("exp_zig_kernel",)), flags)


def build_bisect(source: Optional[str] = None, opt: str = "-O1") -> Path:
    """The host library of ``csrc/bisect_stages.cu`` (or of ``source``),
    the peek's blocks launched as fibers whose warps shuffle as on the
    card; built once per content into ``build/shim/<hash>/lib.so``."""
    if source is None:
        source = (_build.CSRC / "bisect_stages.cu").read_text()
    flags = [f for f in FLAGS if not f.startswith("-O")] + [opt]
    return _compile("bisect_stages.cc",
                    rewrite(source, blocking=("peek_kernel",)), flags)


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
    lanes = kernel_run._check_leaves(leaves, lay["table"], lay, real, count,
                                     sims.t_stop is not None)
    args = kernel_run._chunk_args((lay["E"], lay["W"]), chunk_steps, t_end,
                                  sims)
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


def block(lib: ctypes.CDLL, name: str, states, n: int, out=None):
    """One call of the host-built sampler ``cimba_<name>_<f32|f64>``
    (``name`` as in ``random.block_kernels``: ``exponential_block``,
    ``normal_block``, ``exponential_block_zig``) on a batch of CPU
    streams, as ``block_kernels`` launches it on the card: ``(advanced
    states, [R, n] samples)`` in the current profile; ``out``, a
    contiguous [R, n] CPU tensor (a view at any offset) to write them
    into."""
    from cimba_tpu_torch import config
    from cimba_tpu_torch.random import _ziggurat_tables as zt
    from cimba_tpu_torch.random import block_kernels as bk

    per_sample = 2 * bk._ZK + 1 if name == "exponential_block_zig" else 1
    bk._check(states, n, per_sample)
    words = [x.contiguous() for x in states]
    if words[0].is_cuda:
        raise ValueError("the host-built samplers take streams on the CPU")
    real = config.real()
    fn = getattr(lib, f"cimba_{name}_"
                      f"{'f32' if real == torch.float32 else 'f64'}")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int64] * 2 + [
        ctypes.c_double, ctypes.c_double, ctypes.c_void_p]
    rows = words[0].shape[0]
    if out is None:
        out = torch.empty((rows, n), dtype=real)
    elif out.shape != (rows, n) or out.dtype != real or \
            not out.is_contiguous() or out.is_cuda:
        raise ValueError(f"out must be a contiguous [{rows}, {n}] {real} "
                         "CPU tensor")
    lo, hi = torch.empty_like(words[2]), torch.empty_like(words[3])
    xt = torch.tensor(zt.X_EXP, dtype=real)
    yt = torch.tensor(zt.Y_EXP, dtype=real)
    rc = fn(*[w.data_ptr() for w in words], lo.data_ptr(), hi.data_ptr(),
            out.data_ptr(), xt.data_ptr(), yt.data_ptr(), rows, n, zt.R_EXP,
            zt.V_EXP, None)
    if rc != 0:
        raise RuntimeError(f"{name}: launch refused (code {rc})")
    return states._replace(ctr_lo=lo, ctr_hi=hi), out


def peek(lib: ctypes.CDLL, sims, table, lay: dict):
    """The host-built peek (``cimba_peek_<f32|f64>``) on a Sim of CPU
    tensors, as ``tools.bisect_kernels.peek`` launches it on the card:
    every lane's next event (``eventset.Event``)."""
    from cimba_tpu_torch.core import loop
    from cimba_tpu_torch.tools import bisect_kernels as bk

    leaves = bk._checked(sims, table, lay)
    if leaves[0].is_cuda:
        raise ValueError("the host-built peek takes a Sim on the CPU")
    fn, ptrs, out, outs = bk.peek_args(lib, sims, leaves)
    lanes = leaves[0].shape[0]
    rc = fn(ptrs, len(leaves), lanes, lay["E"], lay["P"], loop.K_PROC, outs,
            None)
    if rc != 0:
        raise RuntimeError(f"peek: launch refused (code {rc})")
    return out
