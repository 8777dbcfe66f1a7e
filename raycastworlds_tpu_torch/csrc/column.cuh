// The camera column of one ray, shared by the fused render kernels
// (crossing_render_pal8.cu, dda_render_u32.cu).
//
// Same float32 expressions as the plain render (ops/render.py
// `column_pads`), each rounded once as eager torch rounds it:
//   proj        = dist * (pdx*dx + pdy*dy)          (fisheye correction)
//   height_line = num / (denom * proj)
//   h_pu        = floor(min(height_line, hpu)), or hpu where not finite
//   pad         = 0 if h_pu >= hpu - 1 else (hpu - h_pu) / 2
// The column is ceiling above the pad, floor from hpu - pad down, slab
// between.  Each thread writes its own column; the threads of a warp own
// neighbouring columns, so every row is written as one coalesced run.

#pragma once

#include <cstddef>

namespace {

__device__ __forceinline__ int column_pad(float dist, float pdx, float pdy,
                                          float dx, float dy, float num,
                                          float denom, int hpu) {
  const float proj =
      __fmul_rn(dist, __fadd_rn(__fmul_rn(pdx, dx), __fmul_rn(pdy, dy)));
  const float height_line = __fdiv_rn(num, __fmul_rn(denom, proj));
  const int h_pu = isfinite(height_line)
                       ? static_cast<int>(floorf(fminf(
                             height_line, static_cast<float>(hpu))))
                       : hpu;
  return h_pu >= hpu - 1 ? 0 : (hpu - h_pu) / 2;
}

// Column `col` of image `img` ([hpu, row_stride] for one env).
template <typename T>
__device__ __forceinline__ void write_column(T* __restrict__ img, int col,
                                             int row_stride, int hpu, int pad,
                                             T ceiling, T slab, T floor_c) {
  for (int row = 0; row < hpu; ++row) {
    const T px = row < pad ? ceiling : (row >= hpu - pad ? floor_c : slab);
    img[static_cast<size_t>(row) * row_stride + col] = px;
  }
}

}  // namespace
