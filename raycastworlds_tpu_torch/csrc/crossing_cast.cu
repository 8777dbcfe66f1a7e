// Crossing raycaster for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel raycastworlds_tpu/ops/raycast_crossing_kernel.py
// (`_kernel`, entry `cast_rays_crossing_kernel`).  It computes what that
// kernel computes, not block by block: the TPU version's host precompute of
// per-candidate line words (`_candidate_words`, a one-hot where-sum written
// to avoid TPU gathers) has no reason to exist here.
//
// One block per (env, chunk of kThreads rays).  The block reads the env's
// packed obstacle words once into shared memory; each thread owns one ray
// and runs crossing_ray (crossing.cuh) over both axes' grid-line crossings.
//
// On this card the kernel is bound by integer and ALU work per (ray,
// candidate) -- a divide, a floor/ceil, a shared-memory bit test and a
// compare for each of the H + W candidates -- not by bytes: it reads 8 bytes
// of direction per ray and writes 16 bytes of results per ray.

#include <cstdint>

#include <cuda_runtime.h>

#include "crossing.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) crossing_cast_kernel(
    const uint32_t* __restrict__ words,  // [B, nw]
    const float* __restrict__ pos,       // [B, 2]
    const float* __restrict__ dirs,      // [B, R, 2]
    int32_t* __restrict__ hit_tu,        // [B, R, 2]
    int32_t* __restrict__ hit_dim,       // [B, R]
    float* __restrict__ dist,            // [B, R]
    int r_total, int h, int w, int nw) {
  extern __shared__ uint32_t s_words[];
  const int b = blockIdx.x;
  for (int q = threadIdx.x; q < nw; q += blockDim.x) {
    s_words[q] = words[static_cast<size_t>(b) * nw + q];
  }
  __syncthreads();

  const int r = blockIdx.y * kThreads + threadIdx.x;
  if (r >= r_total) return;
  const size_t ray = static_cast<size_t>(b) * r_total + r;
  const RayHit hit = crossing_ray(s_words, pos[2 * b], pos[2 * b + 1],
                                  dirs[2 * ray], dirs[2 * ray + 1], h, w);
  dist[ray] = hit.dist;
  hit_tu[2 * ray] = hit.hit_i;
  hit_tu[2 * ray + 1] = hit.hit_j;
  hit_dim[ray] = hit.dim;
}

}  // namespace

// Launches the cast on `stream` and returns cudaGetLastError() (0 = ok).
// All tensors are contiguous and on the current device; b >= 1, r >= 1.
extern "C" int rcw_crossing_cast(
    const void* words, const void* pos, const void* dirs, void* hit_tu,
    void* hit_dim, void* dist, int b, int r, int h, int w, int nw,
    void* stream) {
  const dim3 grid(b, (r + kThreads - 1) / kThreads);
  const size_t smem = static_cast<size_t>(nw) * sizeof(uint32_t);
  crossing_cast_kernel<<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const float*>(pos),
      static_cast<const float*>(dirs), static_cast<int32_t*>(hit_tu),
      static_cast<int32_t*>(hit_dim), static_cast<float*>(dist), r, h, w,
      nw);
  return static_cast<int>(cudaGetLastError());
}

// Largest shared-memory request (in 32-bit words) that a launch of any of
// the library's kernels makes without opting in to more (48 KiB); the
// wrappers refuse maps whose words exceed it.
extern "C" int rcw_max_smem_words() {
  return 48 * 1024 / static_cast<int>(sizeof(uint32_t));
}
