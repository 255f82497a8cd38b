// Closest-hit ray x triangle sweep for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   liverrenderer_tpu/accel/pallas_intersect.py::_intersect_kernel (K1,
//   every triangle resident in VMEM) and ::_intersect_stream_kernel (K2,
//   65,536-triangle blocks streamed along a sequential grid axis).
// The TPU's sequential grid axis becomes the chunk loop inside one block,
// so a single kernel covers every triangle count the dispatcher sends here
// (0 < T <= 2^21).
//
// Contract (shared with the plain PyTorch version
// accel/cuda_intersect.py::intersect_closest_reference):
//   rays  (8, n) f32 rows: ox oy oz dx dy dz maxt (row 7 unused)
//   tris  (Tpad, 16) f32 Baldwin-Weber rows: n xyz, dot(n,p0), r1 xyz, d1,
//         r2 xyz, d2, original triangle id (as a float), 3 pad; Tpad is a
//         multiple of 128 and padded rows are all zero (n.d == 0 => reject)
//   boxes (Tpad/128, 8) f32 chunk AABBs: min xyz, max xyz, 2 pad
//   t_out (n,) f32 closest t (inf on a miss); prim_out (n,) i32 (-1 miss)
// A hit needs |n.d| > 1e-12, u >= 0, v >= 0, u + v <= 1, t > 0 and
// t < min(best_t, maxt).  Within a 128-triangle chunk the minimum t breaks
// ties to the LARGER triangle id; chunks merge on strict '<', so an earlier
// chunk keeps a tie.
//
// Design: one thread per ray, 128 rays per block.  Ray rows are read in the
// (8, n) layout, coalesced across the threads of a warp; the ragged last
// block is masked here (no padding).  The block walks the 128-triangle
// chunks in order.  For each chunk every thread slab-tests the chunk AABB
// against its ray; __syncthreads_or skips the chunk when no ray of the
// block enters it closer than its current best hit (the TPU kernel's tile
// culling, at 128 rays instead of 1024; per-ray results are the same
// because a culled chunk holds no hit for any ray of the block).  A chunk
// that survives is staged cooperatively into shared memory with 16-byte
// loads (8 KB), then every thread runs the Baldwin-Weber test over its 128
// rows, which all threads read at the same address (a broadcast).
//
// Bound: FP32 ALU throughput.  A ray x triangle test is about 38 floating
// point operations on 13 floats that the whole block shares, so the kernel
// reads each chunk once per 128 rays and is far from any memory limit.
// Built without FMA contraction (--fmad=false) and without fast math, so
// each operation rounds as in the plain PyTorch version and the 1e-12 guard
// and the divisions keep IEEE behaviour.  Making it fast is later work:
// double-buffered cp.async/TMA staging, several rays per thread, FMA, and
// warp-level culling.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTileT = 128;                       // triangles per chunk
constexpr int kBlockR = 128;                      // rays (threads) per block
constexpr int kChunkF4 = kTileT * 16 / 4;         // float4s per chunk (512)

__global__ void __launch_bounds__(kBlockR)
intersect_closest_kernel(const float* __restrict__ rays, int n,
                         const float4* __restrict__ tris,
                         const float* __restrict__ boxes, int n_chunks,
                         float* __restrict__ t_out,
                         int* __restrict__ prim_out) {
  __shared__ float4 s_tri[kChunkF4];

  const int r = blockIdx.x * kBlockR + threadIdx.x;
  const bool live = r < n;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float maxt = -1.f;  // dead lanes never enter a box nor hit
  if (live) {
    ox = rays[r];
    oy = rays[n + r];
    oz = rays[2 * n + r];
    dx = rays[3 * n + r];
    dy = rays[4 * n + r];
    dz = rays[5 * n + r];
    maxt = rays[6 * n + r];
  }
  // slab-test reciprocals (as the TPU kernel: |d| <= 1e-20 -> +1e-20)
  const float eps = 1e-20f;
  const float idx = 1.0f / (fabsf(dx) > eps ? dx : eps);
  const float idy = 1.0f / (fabsf(dy) > eps ? dy : eps);
  const float idz = 1.0f / (fabsf(dz) > eps ? dz : eps);

  float best_t = CUDART_INF_F;
  float best_prim = -1.f;

  for (int c = 0; c < n_chunks; ++c) {
    const float* b = boxes + 8 * c;
    const float t0x = (b[0] - ox) * idx, t1x = (b[3] - ox) * idx;
    const float t0y = (b[1] - oy) * idy, t1y = (b[4] - oy) * idy;
    const float t0z = (b[2] - oz) * idz, t1z = (b[5] - oz) * idz;
    const float near = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                             fminf(t0z, t1z));
    const float far = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                            fmaxf(t0z, t1z));
    const float lim = fminf(best_t, maxt);
    const bool enters = live && near <= far && far > 0.f && near < lim;
    // the vote is also the barrier that ends the previous chunk's reads of
    // s_tri before it is overwritten
    if (!__syncthreads_or(enters)) continue;

    const float4* src = tris + static_cast<size_t>(c) * kChunkF4;
    for (int i = threadIdx.x; i < kChunkF4; i += kBlockR) s_tri[i] = src[i];
    __syncthreads();

    float cmin = CUDART_INF_F;
    float cprim = -1.f;
#pragma unroll 4
    for (int j = 0; j < kTileT; ++j) {
      const float4 q0 = s_tri[4 * j];      // n xyz, dn
      const float4 q1 = s_tri[4 * j + 1];  // r1 xyz, d1
      const float4 q2 = s_tri[4 * j + 2];  // r2 xyz, d2
      const float id = s_tri[4 * j + 3].x;
      const float ndir = q0.x * dx + q0.y * dy + q0.z * dz;
      const float no = q0.x * ox + q0.y * oy + q0.z * oz;
      const bool ok = fabsf(ndir) > 1e-12f;
      const float inv = ok ? 1.0f / ndir : 0.0f;
      const float t = (q0.w - no) * inv;
      const float px = ox + t * dx;
      const float py = oy + t * dy;
      const float pz = oz + t * dz;
      const float u = q1.x * px + q1.y * py + q1.z * pz + q1.w;
      const float v = q2.x * px + q2.y * py + q2.z * pz + q2.w;
      const bool hit = ok && u >= 0.f && v >= 0.f && u + v <= 1.f &&
                       t > 0.f && t < best_t && t < maxt;
      if (hit && (t < cmin || (t == cmin && id > cprim))) {
        cmin = t;
        cprim = id;
      }
    }
    if (cmin < best_t) {
      best_t = cmin;
      best_prim = cprim;
    }
  }

  if (live) {
    t_out[r] = best_t;
    prim_out[r] = static_cast<int>(best_prim);
  }
}

}  // namespace

// C ABI for ctypes.  Launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success).
extern "C" int lr_intersect_closest(const float* rays, int n,
                                    const float* tris, const float* boxes,
                                    int n_chunks, float* t_out, int* prim_out,
                                    void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (n + kBlockR - 1) / kBlockR;
  intersect_closest_kernel<<<blocks, kBlockR, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      rays, n, reinterpret_cast<const float4*>(tris), boxes, n_chunks, t_out,
      prim_out);
  return static_cast<int>(cudaGetLastError());
}
