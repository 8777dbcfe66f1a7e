// Fused crossing cast + pal8 camera render for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel raycastworlds_tpu/ops/raycast_crossing_kernel.py
// (`_render_pal8_kernel`, entry `cast_render_pal8_kernel`): the crossing
// cast of crossing.cuh, then the column of column.cuh with a slab chosen
// goal-vs-wall by equality of the hit tile with the env's single goal tile
// (the obstacle map is walls | goal), written as palette indices.  The fan
// arrives mirror-ordered (EnvConfig.ray_fan_lut_flipped), so ray r fills
// image column r.
//
// What bounds it on this card: the image write, one byte x hpu per ray
// (536.9 MB at the reference default, 4096 envs x 512 rays x 256 rows, plus
// 16.8 MB of directions: 165 us at 3.35 TB/s).  The cast in front of it
// was ALU-bound (all H + W candidates per ray, each with a divide); it now
// takes crossing.cuh's early-exit walk (j first, i cut at j's distance,
// each axis left at its first occupied crossing, exact by the monotonicity
// of the crossing distances in k), so the kernel is left with the write.
//
// One block per (env, chunk of kThreads rays), kept because each thread
// writes its own column and a warp's columns make coalesced row runs; the
// block reads the env's packed obstacle words into shared memory once.

#include <cstdint>

#include <cuda_runtime.h>

#include "column.cuh"
#include "crossing.cuh"

namespace {

constexpr int kThreads = 128;

// Palette indices, as colors.py.
constexpr uint8_t kPalCeiling = 1;
constexpr uint8_t kPalWallDimI = 2;
constexpr uint8_t kPalWallDimJ = 3;
constexpr uint8_t kPalFloor = 4;
constexpr uint8_t kPalGoalDimI = 6;
constexpr uint8_t kPalGoalDimJ = 7;

__global__ void __launch_bounds__(kThreads) crossing_render_pal8_kernel(
    const uint32_t* __restrict__ words,  // [B, nw] obstacle words
    const float* __restrict__ pos,       // [B, 2]
    const float* __restrict__ dirs,      // [B, R, 2] mirror-ordered fan
    const float* __restrict__ pdir,      // [B, 2] player direction
    const int32_t* __restrict__ goal,    // [B, 2] goal tile
    uint8_t* __restrict__ img,           // [B, hpu, R]
    int r_total, int h, int w, int nw, int hpu, float num, float denom) {
  extern __shared__ uint32_t s_words[];
  const int b = blockIdx.x;
  for (int q = threadIdx.x; q < nw; q += blockDim.x) {
    s_words[q] = words[static_cast<size_t>(b) * nw + q];
  }
  __syncthreads();

  const int r = blockIdx.y * kThreads + threadIdx.x;
  if (r >= r_total) return;
  const size_t ray = static_cast<size_t>(b) * r_total + r;
  const float dx = dirs[2 * ray];
  const float dy = dirs[2 * ray + 1];
  const RayHit hit =
      crossing_ray(s_words, pos[2 * b], pos[2 * b + 1], dx, dy, h, w);

  const bool dim_i = hit.dim == 0;
  const bool is_goal = hit.hit_i == goal[2 * b] && hit.hit_j == goal[2 * b + 1];
  const uint8_t slab = is_goal ? (dim_i ? kPalGoalDimI : kPalGoalDimJ)
                               : (dim_i ? kPalWallDimI : kPalWallDimJ);
  const int pad = column_pad(hit.dist, pdir[2 * b], pdir[2 * b + 1], dx, dy,
                             num, denom, hpu);
  write_column(img + static_cast<size_t>(b) * hpu * r_total, r, r_total, hpu,
               pad, kPalCeiling, slab, kPalFloor);
}

}  // namespace

// Launches the fused cast and render on `stream` and returns
// cudaGetLastError() (0 = ok).  All tensors are contiguous and on the
// current device; b >= 1, r >= 1, hpu >= 1.
extern "C" int rcw_crossing_render_pal8(
    const void* words, const void* pos, const void* dirs, const void* pdir,
    const void* goal, void* img, int b, int r, int h, int w, int nw, int hpu,
    float num, float denom, void* stream) {
  const dim3 grid(b, (r + kThreads - 1) / kThreads);
  const size_t smem = static_cast<size_t>(nw) * sizeof(uint32_t);
  crossing_render_pal8_kernel<<<grid, kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const float*>(pos),
      static_cast<const float*>(dirs), static_cast<const float*>(pdir),
      static_cast<const int32_t*>(goal), static_cast<uint8_t*>(img), r, h, w,
      nw, hpu, num, denom);
  return static_cast<int>(cudaGetLastError());
}
