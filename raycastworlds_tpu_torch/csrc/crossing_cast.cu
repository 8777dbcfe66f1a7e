// Crossing raycaster for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel raycastworlds_tpu/ops/raycast_crossing_kernel.py
// (`_kernel`, entry `cast_rays_crossing_kernel`).  It computes what that
// kernel computes, not block by block: the TPU version's host precompute of
// per-candidate line words (`_candidate_words`, a one-hot where-sum written
// to avoid TPU gathers) has no reason to exist here.
//
// What bounds it on this card: its bytes are 8 of direction in and 16 of
// results out per ray, 50.4 MB at the reference default (4096 envs x 512
// rays: 15.1 us at 3.35 TB/s).  The first design, every ray running all
// H + W candidates, was bound by ALU work instead: a divide, a floor/ceil, a
// bit test and a compare per candidate, most of them past the hit.  It now
// runs the early-exit walk of crossing.cuh (j first, then i cut at j's
// distance, each axis left at its first occupied crossing, which the
// monotonicity of the crossing distances in k makes the axis's minimum).
//
// Layout: a block of kThreads threads is `env_rows` envs x `ray_cols` rays,
// ray_cols = R rounded up to a warp, at most kThreads.  At R >= 128 that is
// one env per block, at 64 rays two: no half-empty blocks, and half as many
// blocks to schedule, at 32768 envs x 64 rays.  The block stages its envs'
// packed words (4-10 per env at the main paths' maps) in shared memory.
// (A flat B*R ray grid also leaves no lane idle, but its per-thread divide
// by R made it slower at 256 and 512 rays and no faster at 64; float2/int2
// accesses measured no faster than the 4-byte ones kept here.)  It is an
// ALU and store kernel: no tensor cores, TMA or wgmma.  The divide stays
// the IEEE __fdiv_rn (built -prec-div=true, -fmad=false), so the cast
// equals its plain version, the full-loop `cast_rays_crossing_kernel_ref`,
// bit for bit.

#include <cstdint>

#include <cuda_runtime.h>

#include "crossing.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarp = 32;
constexpr int kSmemWords = 48 * 1024 / static_cast<int>(sizeof(uint32_t));

__global__ void __launch_bounds__(kThreads) crossing_cast_kernel(
    const uint32_t* __restrict__ words,  // [B, nw]
    const float* __restrict__ pos,       // [B, 2]
    const float* __restrict__ dirs,      // [B, R, 2]
    int32_t* __restrict__ hit_tu,        // [B, R, 2]
    int32_t* __restrict__ hit_dim,       // [B, R]
    float* __restrict__ dist,            // [B, R]
    int b_total, int r_total, int h, int w, int nw) {
  // blockDim = (ray_cols, env_rows); block (x, y) holds envs
  // [x * env_rows, ...) and rays [y * ray_cols, ...) of each.
  extern __shared__ uint32_t s_words[];
  const int b0 = blockIdx.x * blockDim.y;
  const int n_words = min(static_cast<int>(blockDim.y), b_total - b0) * nw;
  const uint32_t* src = words + static_cast<size_t>(b0) * nw;
  const int threads = blockDim.x * blockDim.y;
  for (int q = threadIdx.y * blockDim.x + threadIdx.x; q < n_words;
       q += threads) {
    s_words[q] = src[q];
  }
  __syncthreads();

  const int b = b0 + threadIdx.y;
  const int r = blockIdx.y * blockDim.x + threadIdx.x;
  if (b >= b_total || r >= r_total) return;
  const size_t ray = static_cast<size_t>(b) * r_total + r;
  const RayHit hit =
      crossing_ray(s_words + threadIdx.y * nw, pos[2 * b], pos[2 * b + 1],
                   dirs[2 * ray], dirs[2 * ray + 1], h, w);
  dist[ray] = hit.dist;
  hit_tu[2 * ray] = hit.hit_i;
  hit_tu[2 * ray + 1] = hit.hit_j;
  hit_dim[ray] = hit.dim;
}

}  // namespace

// Launches the cast on `stream` and returns cudaGetLastError() (0 = ok).
// All tensors are contiguous and on the current device; b >= 1, r >= 1,
// nw <= rcw_max_smem_words().
extern "C" int rcw_crossing_cast(
    const void* words, const void* pos, const void* dirs, void* hit_tu,
    void* hit_dim, void* dist, int b, int r, int h, int w, int nw,
    void* stream) {
  const int ray_cols = min((r + kWarp - 1) / kWarp * kWarp, kThreads);
  int env_rows = kThreads / ray_cols;
  while (env_rows > 1 && env_rows * nw > kSmemWords) env_rows /= 2;
  const dim3 block(ray_cols, env_rows);
  const dim3 grid((b + env_rows - 1) / env_rows,
                  (r + ray_cols - 1) / ray_cols);
  const size_t smem = static_cast<size_t>(env_rows) * nw * sizeof(uint32_t);
  crossing_cast_kernel<<<grid, block, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const float*>(pos),
      static_cast<const float*>(dirs), static_cast<int32_t*>(hit_tu),
      static_cast<int32_t*>(hit_dim), static_cast<float*>(dist), b, r, h, w,
      nw);
  return static_cast<int>(cudaGetLastError());
}

// Largest shared-memory request (in 32-bit words) that a launch of any of
// the library's kernels makes without opting in to more (48 KiB); the
// wrappers refuse maps whose words exceed it.
extern "C" int rcw_max_smem_words() { return kSmemWords; }
