// Threefry-2x32 (20 rounds), the hash of `rng.py` (`threefry2x32`), shared
// by the kernels that draw random numbers (threefry.cu, maze_reset.cu).
//
// The arithmetic stays native uint32 in registers, each rotation one funnel
// shift: 78 integer operations a hash (20 rounds of add, rotate and xor; 5
// key injections of 3 adds; 3 to set up).

#pragma once

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return __funnelshift_l(v, v, r);
}

// Four rounds: mix, rotate by R, xor.
template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = rotl(x1, R0) ^ x0;
  x0 += x1; x1 = rotl(x1, R1) ^ x0;
  x0 += x1; x1 = rotl(x1, R2) ^ x0;
  x0 += x1; x1 = rotl(x1, R3) ^ x0;
}

// The hash of key (k0, k1) over the counter words (0, c): both output words.
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1, uint32_t c) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = k0;  // counter word 0 is 0
  uint32_t x1 = c + k1;
  // five groups of four rounds, each followed by a key injection
  rounds<13, 15, 26, 6>(x0, x1);  x0 += k1;  x1 += k2 + 1u;
  rounds<17, 29, 16, 24>(x0, x1); x0 += k2;  x1 += k0 + 2u;
  rounds<13, 15, 26, 6>(x0, x1);  x0 += k0;  x1 += k1 + 3u;
  rounds<17, 29, 16, 24>(x0, x1); x0 += k1;  x1 += k2 + 4u;
  rounds<13, 15, 26, 6>(x0, x1);  x0 += k2;  x1 += k0 + 5u;
  return make_uint2(x0, x1);
}

}  // namespace
