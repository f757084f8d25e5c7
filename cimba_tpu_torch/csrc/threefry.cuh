// Threefry-2x32, 20 rounds (Salmon et al., SC'11), bit-identical to
// cimba_tpu/random/bits.py and cimba_tpu_torch/random/bits.py.
#pragma once

#include <cstdint>

namespace cimba {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

#define CIMBA_TF_ROUND(r) \
  x0 += x1;               \
  x1 = rotl32(x1, r);     \
  x1 ^= x0;

#define CIMBA_TF_MIX_A \
  CIMBA_TF_ROUND(13) CIMBA_TF_ROUND(15) CIMBA_TF_ROUND(26) CIMBA_TF_ROUND(6)
#define CIMBA_TF_MIX_B \
  CIMBA_TF_ROUND(17) CIMBA_TF_ROUND(29) CIMBA_TF_ROUND(16) CIMBA_TF_ROUND(24)

__device__ __forceinline__ void threefry2x32(
    uint32_t k0, uint32_t k1, uint32_t c0, uint32_t c1, uint32_t& o0,
    uint32_t& o1) {
  const uint32_t ks2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + k0;
  uint32_t x1 = c1 + k1;
  CIMBA_TF_MIX_A x0 += k1;  x1 += ks2 + 1u;
  CIMBA_TF_MIX_B x0 += ks2; x1 += k0 + 2u;
  CIMBA_TF_MIX_A x0 += k0;  x1 += k1 + 3u;
  CIMBA_TF_MIX_B x0 += k1;  x1 += ks2 + 4u;
  CIMBA_TF_MIX_A x0 += ks2; x1 += k0 + 5u;
  o0 = x0;
  o1 = x1;
}

#undef CIMBA_TF_MIX_B
#undef CIMBA_TF_MIX_A
#undef CIMBA_TF_ROUND

}  // namespace cimba
