// The crossing cast of one ray, shared by crossing_cast.cu and
// crossing_render_pal8.cu.
//
// Replaces the candidate loop of the TPU kernel
// raycastworlds_tpu/ops/raycast_crossing_kernel.py (`_kernel`, and the cast
// inside `_render_pal8_kernel`).
//
// A ray leaving p along d crosses at most H i-lines and W j-lines before the
// border walls stop it; crossing k of an axis enters one tile at the closed
// form distance t_k = (frac + k) / |d|.  The plain version
// (`cast_rays_crossing_kernel_ref`) keeps, per axis, a running (t, k) minimum
// over all n candidates under a strict `<` in ascending k, and then takes
// the nearer axis, ties to the j face.  The kernels around this walk are
// bound by bytes on this card (crossing_cast.cu: 50.4 MB at the reference
// default, 4096 envs x 512 rays, 15.1 us at 3.35 TB/s;
// crossing_render_pal8.cu: 553.7 MB, 165 us), but the full loop made them
// ALU-bound: a divide, a floor/ceil, a bit test and a compare for every
// candidate, and most candidates lie past the hit.  So each axis is walked
// and left early, with the same result bit for bit:
//
// * Early exit.  t_k = __fdiv_rn(__fadd_rn(frac_sel, k), ad) never
//   decreases in k: for a fixed ad > 0 both roundings are monotone, and
//   frac_sel + k grows with k.  Under the strict `<` in ascending k the
//   first occupied candidate with t < FLT_MAX is therefore the axis's
//   minimum, and the walk stops there.  Once t_k >= FLT_MAX (overflow to
//   +inf included) no later candidate can pass `t < FLT_MAX`, so the walk
//   stops too.  With ad == 0 no candidate is finite: the loop is skipped
//   and the axis keeps best = FLT_MAX, k = 0, cross tile 0, as the full loop
//   leaves it.
// * Cross-axis cut.  The nearer axis wins with ties to j (use_j = tj <= ti),
//   so j is walked first and i only while t_k < tj: an i candidate at
//   t_k >= tj, and every later one, can only give ti >= tj, where j wins
//   whatever ti is.  The walk reads `!(t < t_stop)` as its stop; a NaN t
//   arises only as 0/0, with ad == 0 and frac_sel == 0 at k = 0, and ad == 0
//   never enters the loop, so no NaN ends a walk that had candidates left.
//
// Float exactness against the plain version: every mul, add and divide is an
// explicit round-to-nearest intrinsic (the library is built with
// -fmad=false), so the cross coordinate p + t*d rounds twice as in eager
// torch and t is the IEEE quotient; no reciprocal multiply.  The cross tile
// is clamped before the float->int conversion, and the entered main tile is
// clamped into the map, as in the plain version (maps without a border
// ring repeat the edge tile).

#pragma once

#include <cfloat>
#include <cstdint>

namespace {

struct AxisBest {
  float t;  // smallest occupied crossing distance below t_stop, else FLT_MAX
  int m;    // entered tile on the crossed axis
  int c;    // entered tile on the other axis
};

// The early-exit walk over one axis's n crossing candidates; candidates at
// t >= t_stop are not looked at.  `words` are the env's packed words (in
// shared memory).  main_is_i: the crossed lines are i-lines (bit m*W + c),
// else j-lines (bit c*W + m).
__device__ __forceinline__ AxisBest axis_walk(
    const uint32_t* __restrict__ words, float d_main, float d_cross,
    float p_main, float p_cross, int n, int size_cross, int w, bool main_is_i,
    float t_stop) {
  const float fl = floorf(p_main);
  const int main0 = __float2int_rd(p_main);
  const int step = d_main < 0.f ? -1 : 1;
  const float frac = __fsub_rn(p_main, fl);
  const float frac_sel = d_main < 0.f ? frac : __fsub_rn(1.0f, frac);
  const float ad = fabsf(d_main);
  const float c_max = static_cast<float>(size_cross - 1);

  if (ad > 0.f) {
    for (int k = 0; k < n; ++k) {
      const float t =
          __fdiv_rn(__fadd_rn(frac_sel, static_cast<float>(k)), ad);
      if (!(t < t_stop)) break;  // t never decreases in k
      const float c = __fadd_rn(p_cross, __fmul_rn(t, d_cross));
      float c_tile;
      if (main_is_i) {
        c_tile = d_cross >= 0.f ? floorf(c) : __fsub_rn(ceilf(c), 1.0f);
      } else {
        c_tile = d_cross > 0.f ? __fsub_rn(ceilf(c), 1.0f) : floorf(c);
      }
      const int c_idx = static_cast<int>(fminf(fmaxf(c_tile, 0.f), c_max));
      const int m = min(max(main0 + (k + 1) * step, 0), n - 1);
      const int bit = main_is_i ? m * w + c_idx : c_idx * w + m;
      if ((words[bit >> 5] >> (bit & 31)) & 1u) {
        return {t, main0 + (k + 1) * step, c_idx};
      }
    }
  }
  return {FLT_MAX, main0 + step, 0};
}

struct RayHit {
  int hit_i;
  int hit_j;
  int dim;     // 0 = i-face, 1 = j-face
  float dist;  // distance along the ray to the face
};

// j first, then i cut at j's distance; ties resolve to the j face, as the
// sequential march checks j first.
__device__ __forceinline__ RayHit crossing_ray(
    const uint32_t* __restrict__ words, float px, float py, float dx,
    float dy, int h, int w) {
  const AxisBest aj =
      axis_walk(words, dy, dx, py, px, w, h, w, false, FLT_MAX);
  const AxisBest ai = axis_walk(words, dx, dy, px, py, h, w, w, true, aj.t);
  const bool use_j = aj.t <= ai.t;
  return use_j ? RayHit{aj.c, aj.m, 1, aj.t} : RayHit{ai.m, ai.c, 0, ai.t};
}

}  // namespace
