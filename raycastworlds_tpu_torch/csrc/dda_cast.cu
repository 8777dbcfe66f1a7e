// DDA raycaster for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel raycastworlds_tpu/ops/raycast_pallas.py
// (`_kernel`, entry `cast_rays_pallas_batched`): a fixed-trip DDA march in
// the scan's arithmetic order over bit-packed maps.  The TPU version marches
// a [block of envs, R] tile in lockstep with 0/1 integer blends (a Mosaic
// layout workaround) and selects each lane's word with a multiply-add chain;
// here each thread marches one ray (dda.cuh) and stops at its hit, and the
// occupancy test reads the env's words from shared memory.
//
// One block per (env, chunk of kThreads rays); the block reads the env's
// packed obstacle words into shared memory once.  Bound by the serial march
// (at most max_steps dependent steps of a compare, an add and a shared-memory
// bit test per ray), not by bytes: 8 bytes in and 16 bytes out per ray.

#include <cstdint>

#include <cuda_runtime.h>

#include "dda.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) dda_cast_kernel(
    const uint32_t* __restrict__ words,  // [B, nw]
    const float* __restrict__ pos,       // [B, 2]
    const float* __restrict__ dirs,      // [B, R, 2]
    int32_t* __restrict__ hit_tu,        // [B, R, 2]
    int32_t* __restrict__ hit_dim,       // [B, R]
    float* __restrict__ dist,            // [B, R]
    int r_total, int h, int w, int nw, int max_steps) {
  extern __shared__ uint32_t s_words[];
  const int b = blockIdx.x;
  for (int q = threadIdx.x; q < nw; q += blockDim.x) {
    s_words[q] = words[static_cast<size_t>(b) * nw + q];
  }
  __syncthreads();

  const int r = blockIdx.y * kThreads + threadIdx.x;
  if (r >= r_total) return;
  const size_t ray = static_cast<size_t>(b) * r_total + r;
  const DdaHit hit = dda_march(s_words, pos[2 * b], pos[2 * b + 1],
                               dirs[2 * ray], dirs[2 * ray + 1], h, w,
                               max_steps);
  hit_tu[2 * ray] = hit.map_i;
  hit_tu[2 * ray + 1] = hit.map_j;
  hit_dim[ray] = hit.dim;
  dist[ray] = hit.dist;
}

}  // namespace

// Launches the march on `stream` and returns cudaGetLastError() (0 = ok).
// All tensors are contiguous and on the current device; b >= 1, r >= 1.
extern "C" int rcw_dda_cast(
    const void* words, const void* pos, const void* dirs, void* hit_tu,
    void* hit_dim, void* dist, int b, int r, int h, int w, int nw,
    int max_steps, void* stream) {
  const dim3 grid(b, (r + kThreads - 1) / kThreads);
  const size_t smem = static_cast<size_t>(nw) * sizeof(uint32_t);
  dda_cast_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const float*>(pos),
      static_cast<const float*>(dirs), static_cast<int32_t*>(hit_tu),
      static_cast<int32_t*>(hit_dim), static_cast<float*>(dist), r, h, w, nw,
      max_steps);
  return static_cast<int>(cudaGetLastError());
}
