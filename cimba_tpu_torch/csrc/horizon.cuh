// A chunk's horizon on the card, shared by the chunk kernels
// (queue_chunk.cu, awacs_chunk.cu): the reference's make_cond reads a
// Sim's per-lane t_stop leaf in place of its static t_end
// (cimba_tpu/core/loop.py make_cond), and so does a chunk.
#pragma once

namespace cimba {

// kernel_run.H_*: no horizon, the scalar t_end, or each lane's t_stop
// leaf, which follows the Sim's other leaves in the pointer array
enum Horizon { H_NONE = 0, H_SCALAR = 1, H_LANE = 2 };

// lane l's t_stop, loaded at each liveness test through the read-only
// cache (a 4- or 8-byte load an event) by a load the compiler can neither
// hoist out of the event loop nor merge: a register kept live across the
// loop would spill the widest generated instances (park2, harbor and
// park3 hold 199-255 registers)
template <typename R>
__device__ __forceinline__ R lane_horizon(const void* t_stop, int l) {
  const R* p = static_cast<const R*>(t_stop) + l;
#ifdef __CUDA_ARCH__
  R v;
  if constexpr (sizeof(R) == 4) {
    asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  } else {
    asm volatile("ld.global.nc.f64 %0, [%1];" : "=d"(v) : "l"(p));
  }
  return v;
#else
  return *static_cast<const volatile R*>(p);
#endif
}

// the liveness test's horizon term: nxt <= lim in the TIME type, lim the
// lane's t_stop or t_end (make_cond's compare on the same values, so
// +inf gives no horizon's decisions and -inf a lane dead on arrival)
template <typename R>
__device__ __forceinline__ bool within_horizon(R nxt, int horizon, R t_end,
                                               const void* t_stop, int l) {
  if (horizon == H_NONE) return true;
  return nxt <= (horizon == H_LANE ? lane_horizon<R>(t_stop, l) : t_end);
}

}  // namespace cimba
