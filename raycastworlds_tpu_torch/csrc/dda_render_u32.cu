// Fused DDA march + u32 camera render for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel raycastworlds_tpu/ops/render_fused.py (`_kernel`,
// entry `render_camera_fused_batched`): the march of dda.cuh, then the slab
// colour from the hit tile's wall (and block) bit, the fisheye-corrected
// column height and the ceiling/slab/floor composite of column.cuh, so the
// per-ray hits never reach device memory.  The fan arrives mirror-ordered
// (EnvConfig.ray_fan_lut_flipped), so ray r fills image column r.
//
// One block per (env, chunk of kThreads rays); the block reads the env's
// obstacle, wall and (optional) block words into shared memory once.  At
// the default shape the kernel is bound by its image write: 4 bytes x hpu
// per ray (2 GiB at 4096 envs x 512 rays x 256 rows), against 8 bytes of
// direction read per ray and a march of at most max_steps steps.

#include <cstdint>

#include <cuda_runtime.h>

#include "column.cuh"
#include "dda.cuh"

namespace {

constexpr int kThreads = 128;

// 0x00RRGGBB, as colors.py.
constexpr uint32_t kCeiling = 0x00FFFFFF;
constexpr uint32_t kFloor = 0x00404040;
constexpr uint32_t kWallDimI = 0x00808080;
constexpr uint32_t kWallDimJ = 0x00C0C0C0;
constexpr uint32_t kGoalDimI = 0x00800000;
constexpr uint32_t kGoalDimJ = 0x00C00000;
constexpr uint32_t kBlockDimI = 0x00000080;
constexpr uint32_t kBlockDimJ = 0x000000C0;

__global__ void __launch_bounds__(kThreads) dda_render_u32_kernel(
    const uint32_t* __restrict__ obstacle,  // [B, nw]
    const uint32_t* __restrict__ wall,      // [B, nw]
    const uint32_t* __restrict__ block,     // [B, nw] or nullptr
    const float* __restrict__ pos,          // [B, 2]
    const float* __restrict__ pdir,         // [B, 2] player direction
    const float* __restrict__ dirs,         // [B, R, 2] mirror-ordered fan
    uint32_t* __restrict__ img,             // [B, hpu, R]
    int r_total, int h, int w, int nw, int max_steps, int hpu, float num,
    float denom) {
  extern __shared__ uint32_t s_words[];  // obstacle | wall | block
  const int b = blockIdx.x;
  const size_t row0 = static_cast<size_t>(b) * nw;
  for (int q = threadIdx.x; q < nw; q += blockDim.x) {
    s_words[q] = obstacle[row0 + q];
    s_words[nw + q] = wall[row0 + q];
    if (block != nullptr) s_words[2 * nw + q] = block[row0 + q];
  }
  __syncthreads();

  const int r = blockIdx.y * kThreads + threadIdx.x;
  if (r >= r_total) return;
  const size_t ray = static_cast<size_t>(b) * r_total + r;
  const float dx = dirs[2 * ray];
  const float dy = dirs[2 * ray + 1];
  const DdaHit hit = dda_march(s_words, pos[2 * b], pos[2 * b + 1], dx, dy,
                               h, w, max_steps);

  const int bit = tile_bit(hit.map_i, hit.map_j, h, w);
  const bool dim_i = hit.dim == 0;
  const bool is_wall = test_bit(s_words + nw, bit);
  uint32_t slab = is_wall ? (dim_i ? kWallDimI : kWallDimJ)
                          : (dim_i ? kGoalDimI : kGoalDimJ);
  if (block != nullptr && !is_wall && test_bit(s_words + 2 * nw, bit)) {
    slab = dim_i ? kBlockDimI : kBlockDimJ;
  }
  const int pad = column_pad(hit.dist, pdir[2 * b], pdir[2 * b + 1], dx, dy,
                             num, denom, hpu);
  write_column(img + static_cast<size_t>(b) * hpu * r_total, r, r_total, hpu,
               pad, kCeiling, slab, kFloor);
}

}  // namespace

// Launches the fused render on `stream` and returns cudaGetLastError()
// (0 = ok).  `block` may be null (no block layer).  All tensors are
// contiguous and on the current device; b >= 1, r >= 1, hpu >= 1.
extern "C" int rcw_dda_render_u32(
    const void* obstacle, const void* wall, const void* block,
    const void* pos, const void* pdir, const void* dirs, void* img, int b,
    int r, int h, int w, int nw, int max_steps, int hpu, float num,
    float denom, void* stream) {
  const dim3 grid(b, (r + kThreads - 1) / kThreads);
  const int parts = block != nullptr ? 3 : 2;
  const size_t smem = static_cast<size_t>(parts) * nw * sizeof(uint32_t);
  dda_render_u32_kernel<<<grid, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(obstacle),
      static_cast<const uint32_t*>(wall), static_cast<const uint32_t*>(block),
      static_cast<const float*>(pos), static_cast<const float*>(pdir),
      static_cast<const float*>(dirs), static_cast<uint32_t*>(img), r, h, w,
      nw, max_steps, hpu, num, denom);
  return static_cast<int>(cudaGetLastError());
}
