// The crossing cast of one ray, shared by crossing_cast.cu and
// crossing_render_pal8.cu.
//
// A ray leaving p along d crosses at most H i-lines and W j-lines before the
// border walls stop it; crossing k of an axis enters one tile at the closed
// form distance t = (frac + k) / |d|.  Each axis keeps a running
// lexicographic (t, k) minimum over its occupied crossings, testing the
// entered tile's bit in the env's packed words directly.
//
// Float exactness against the plain PyTorch version (bit for bit): every
// mul, add and divide is an explicit round-to-nearest intrinsic (and the
// library is built with -fmad=false), so the cross coordinate p + t*d
// rounds twice as in eager torch and t is the IEEE quotient.  A non-finite
// t is masked to c = 0 before floor/ceil, and the cross tile is clamped
// before the float->int conversion.

#pragma once

#include <cfloat>
#include <cstdint>

namespace {

struct AxisBest {
  float t;  // smallest occupied crossing distance, FLT_MAX if none
  int m;    // entered tile on the crossed axis
  int c;    // entered tile on the other axis
};

// Running lexicographic min over one axis's n crossing candidates.
// main_is_i: the crossed lines are i-lines (bit m*W + c), else j-lines
// (bit c*W + m).
__device__ __forceinline__ AxisBest axis_min(
    const uint32_t* __restrict__ words, float d_main, float d_cross,
    float p_main, float p_cross, int n, int size_cross, int w,
    bool main_is_i) {
  const float fl = floorf(p_main);
  const int main0 = __float2int_rd(p_main);
  const int step = d_main < 0.f ? -1 : 1;
  const float frac = __fsub_rn(p_main, fl);
  const float frac_sel = d_main < 0.f ? frac : __fsub_rn(1.0f, frac);
  const float ad = fabsf(d_main);
  const float c_max = static_cast<float>(size_cross - 1);

  float best = FLT_MAX;
  int kb = 0;
  int cb = 0;
  for (int k = 0; k < n; ++k) {
    const float t = __fdiv_rn(__fadd_rn(frac_sel, static_cast<float>(k)), ad);
    const bool finite = isfinite(t);
    const float c = finite ? __fadd_rn(p_cross, __fmul_rn(t, d_cross)) : 0.f;
    float c_tile;
    if (main_is_i) {
      c_tile = d_cross >= 0.f ? floorf(c) : __fsub_rn(ceilf(c), 1.0f);
    } else {
      c_tile = d_cross > 0.f ? __fsub_rn(ceilf(c), 1.0f) : floorf(c);
    }
    const int c_idx = static_cast<int>(fminf(fmaxf(c_tile, 0.f), c_max));
    const int m = min(max(main0 + (k + 1) * step, 0), n - 1);
    const int bit = main_is_i ? m * w + c_idx : c_idx * w + m;
    const bool occ = finite && ((words[bit >> 5] >> (bit & 31)) & 1u);
    const float tm = occ ? t : FLT_MAX;
    if (tm < best) {  // ascending k, strict <: the first minimum wins
      best = tm;
      kb = k;
      cb = c_idx;
    }
  }
  return {best, main0 + (kb + 1) * step, cb};
}

struct RayHit {
  int hit_i;
  int hit_j;
  int dim;     // 0 = i-face, 1 = j-face
  float dist;  // distance along the ray to the face
};

// Both axes, then the nearer; distance ties resolve to the j face, as the
// sequential march checks j first.
__device__ __forceinline__ RayHit crossing_ray(
    const uint32_t* __restrict__ words, float px, float py, float dx,
    float dy, int h, int w) {
  const AxisBest ai = axis_min(words, dx, dy, px, py, h, w, w, true);
  const AxisBest aj = axis_min(words, dy, dx, py, px, w, h, w, false);
  const bool use_j = aj.t <= ai.t;
  return use_j ? RayHit{aj.c, aj.m, 1, aj.t} : RayHit{ai.m, ai.c, 0, ai.t};
}

}  // namespace
