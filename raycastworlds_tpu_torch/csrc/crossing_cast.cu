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
// and loops k over both axes' grid-line crossings, testing the entered
// tile's bit directly and keeping a running (t, k, cross tile) minimum.
//
// On this card the kernel is bound by integer and ALU work per (ray,
// candidate) -- a divide, a floor/ceil, a shared-memory bit test and a
// compare for each of the H + W candidates -- not by bytes: it reads 8 bytes
// of direction per ray and writes 16 bytes of results per ray.
//
// Float exactness against the plain PyTorch version (bit for bit): every
// mul, add and divide is an explicit round-to-nearest intrinsic (and the
// library is built with -fmad=false), so the cross coordinate p + t*d
// rounds twice as in eager torch and t = (frac + k)/|d| is the IEEE
// quotient.  A non-finite t is masked to c = 0 before floor/ceil, and the
// cross tile is clamped before the float->int conversion.

#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

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
  const float px = pos[2 * b];
  const float py = pos[2 * b + 1];
  const float dx = dirs[2 * ray];
  const float dy = dirs[2 * ray + 1];

  const AxisBest ai = axis_min(s_words, dx, dy, px, py, h, w, w, true);
  const AxisBest aj = axis_min(s_words, dy, dx, py, px, w, h, w, false);
  const bool use_j = aj.t <= ai.t;  // ties check j first
  dist[ray] = use_j ? aj.t : ai.t;
  hit_tu[2 * ray] = use_j ? aj.c : ai.m;
  hit_tu[2 * ray + 1] = use_j ? aj.m : ai.c;
  hit_dim[ray] = use_j ? 1 : 0;
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

// Largest shared-memory request the launch above makes without opting in
// to more (48 KiB); the wrapper refuses maps whose words exceed it.
extern "C" int rcw_crossing_cast_max_words() {
  return 48 * 1024 / static_cast<int>(sizeof(uint32_t));
}
