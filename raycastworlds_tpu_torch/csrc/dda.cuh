// The DDA march of one ray, shared by dda_cast.cu and dda_render_u32.cu.
//
// Lodev/Wolfenstein DDA in the float32 order of the plain scan
// (ops/raycast.py `cast_rays_scan`): delta = |1/d| is the ray length per
// unit axis step (+inf on an exact-zero component), side is the ray length
// to the next grid line of each axis, and each step advances the axis with
// the smaller side (a tie steps j); the hit distance is that axis's side
// before the step.  The entered tile's bit is tested in the env's packed
// words, with the tile clamped into the map.
//
// Bit for bit with the scan: the divide, multiply and adds are explicit
// round-to-nearest intrinsics, and the untaken axis is left as it is (a
// select, never `side + go * delta`, which is NaN when delta is +inf).  A
// ray stops at its hit, as the scan freezes hit rays; a ray that never hits
// marches all max_steps and reports its final tile with dist FLT_MAX.

#pragma once

#include <cfloat>
#include <cstdint>

namespace {

struct DdaHit {
  int map_i;   // final tile: the hit tile, or where a miss ended
  int map_j;
  int dim;     // 0 = i-face, 1 = j-face
  float dist;  // FLT_MAX where the ray did not hit
};

__device__ __forceinline__ bool test_bit(const uint32_t* __restrict__ words,
                                         int bit) {
  return (words[bit >> 5] >> (bit & 31)) & 1u;
}

// Bit index of tile (i, j) clamped into an h x w map.
__device__ __forceinline__ int tile_bit(int i, int j, int h, int w) {
  return min(max(i, 0), h - 1) * w + min(max(j, 0), w - 1);
}

__device__ __forceinline__ DdaHit dda_march(
    const uint32_t* __restrict__ words, float px, float py, float dx,
    float dy, int h, int w, int max_steps) {
  const float fx = floorf(px);
  const float fy = floorf(py);
  int map_i = static_cast<int>(fx);
  int map_j = static_cast<int>(fy);
  const float delta_i = fabsf(__fdiv_rn(1.0f, dx));
  const float delta_j = fabsf(__fdiv_rn(1.0f, dy));
  const int step_i = dx < 0.f ? -1 : 1;
  const int step_j = dy < 0.f ? -1 : 1;
  const float frac_i = __fsub_rn(px, fx);
  const float frac_j = __fsub_rn(py, fy);
  float side_i = __fmul_rn(dx < 0.f ? frac_i : __fsub_rn(1.0f, frac_i), delta_i);
  float side_j = __fmul_rn(dy < 0.f ? frac_j : __fsub_rn(1.0f, frac_j), delta_j);

  for (int s = 0; s < max_steps; ++s) {
    const bool take_i = side_i < side_j;
    const float cross = fminf(side_i, side_j);
    if (take_i) {
      map_i += step_i;
      side_i = __fadd_rn(side_i, delta_i);
    } else {
      map_j += step_j;
      side_j = __fadd_rn(side_j, delta_j);
    }
    if (test_bit(words, tile_bit(map_i, map_j, h, w))) {
      return {map_i, map_j, take_i ? 0 : 1, cross};
    }
  }
  return {map_i, map_j, 0, FLT_MAX};
}

}  // namespace
