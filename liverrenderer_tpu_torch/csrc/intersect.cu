// Closest-hit ray x triangle sweep for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   liverrenderer_tpu/accel/pallas_intersect.py::_intersect_kernel (K1,
//   every triangle resident in VMEM) and ::_intersect_stream_kernel (K2,
//   65,536-triangle blocks streamed along a sequential grid axis).
// The TPU's sequential grid axis becomes a chunk loop inside each block plus
// a split of the chunk range over the grid's second dimension, so one pair
// of kernels covers every triangle count the dispatcher sends here
// (0 < T <= 2^21).
//
// Contract (shared with the plain PyTorch version
// accel/cuda_intersect.py::intersect_closest_reference):
//   rays  (8, n) f32 rows: ox oy oz dx dy dz maxt (row 7 unused)
//   tris  (Tpad, 16) f32 Baldwin-Weber rows: n xyz, dot(n,p0), r1 xyz, d1,
//         r2 xyz, d2, original triangle id (as a float), 3 pad; Tpad is a
//         multiple of 128 and padded rows are all zero (n.d == 0 => reject)
//   boxes (Tpad/128, 8) f32 chunk AABBs: min xyz, max xyz, 2 pad
//   t (n,) f32 closest t (inf on a miss); prim (n,) i32 (-1 on a miss)
// A hit needs |n.d| > 1e-12, u >= 0, v >= 0, u + v <= 1, t > 0 and
// t < min(best_t, maxt).  Within a 128-triangle chunk the minimum t breaks
// ties to the LARGER triangle id; chunks merge on strict '<', so an earlier
// chunk keeps a tie.  That order is (t, chunk, -id) lexicographic, so the
// chunk range can be cut into splits whose partial results merge in split
// order with strict '<'.
//
// Design.
// * Sweep kernel, 128 threads and 256 rays per block (two rays owned per
//   thread; the ray rows are read coalesced into shared memory, the ragged
//   last block is masked; at most 64 registers, so 8 blocks fit per SM).
//   blockIdx.y selects a contiguous range of chunks (a split): the wrapper
//   cuts the chunk range until the grid holds WAVES (cuda_intersect.py)
//   times the blocks the card keeps resident, so all 132 SMs work even on a
//   16,384-ray wavefront.
//   Each split writes a partial (t, prim) per ray.
// * Merge kernel: one thread per ray walks the splits in order with strict
//   '<' and writes the result.  With one split the sweep writes the result
//   itself and the merge is not launched.
// * Staging: chunks go through a two-slot shared-memory ring with cp.async
//   (16 KB); the copy of chunk c+1 starts before the tests of chunk c.
// * Culling and compaction: each owner slab-tests the next chunk's box for
//   its rays (the entry distance is kept); the block stages a chunk only if
//   some ray enters it before its current limit (__syncthreads_or), and
//   then lists the rays that still enter it (ballot + one shared atomic per
//   warp).  Only listed rays are tested, so the work follows the tests the
//   rays need, not the union over a warp of rays pointing everywhere.  A
//   short list spreads each ray over a group of up to 32 lanes that split
//   the chunk's 128 rows and reduce (t, id) with __shfl_xor_sync under the
//   in-chunk tie rule, so the block's four warps share even a few rays.  A
//   skipped chunk holds no hit for that ray except a grazing one outside its
//   box by a rounding error; padded chunks (empty boxes) are skipped.
// * Work per test: one broadcast float4 shared load (n, dn).  n.d and n.o
//   (exact, see below) give t_num = dn - n.o; a pair is a candidate only if
//   |n.d| > 1e-12, t_num and n.d have the same sign (t > 0) and
//   |t_num| <= lim' * |n.d| (t below the ray's limit or the lane's best in
//   this chunk; lim' is the limit widened by 1e-6 relative and floored at
//   1e-20, so the prefilter never rejects a pair the exact test would
//   take).  Only candidates read r1/r2 and compute p, u and v, from an
//   approximate t (one rcp.approx); only pairs whose u and v pass take the
//   IEEE reciprocal for the exact t, and the id is read only on an update.
// * Two barriers per chunk: one publishes the landed chunk and the previous
//   chunk's hits, the other closes the list and carries the next chunk's
//   vote.
//
// Bound: FP32 arithmetic throughput.  A ray x triangle test is about 38
// floating-point operations on 13 floats that every ray of the block shares,
// so the sweep reads each chunk once per block (8 KB per 256 rays) and is
// far from any memory limit.  The prefilter cuts a rejected pair to the
// two dot products and a subtraction (11 operations) plus the compares; only
// candidates pay the whole test.
// The merge reads t of every split (4 bytes per split and ray), the
// winner's prim, and writes t and prim: it is bound by bytes.
//
// Arithmetic, against the plain version (which rounds every operation
// separately):
// * t is bit-identical: n.d and n.o use __fmul_rn/__fadd_rn (never
//   contracted), t = t_num * rcp_rn(n.d) as in the plain version.  With FMA
//   in n.o, t_num = dn - n.o could round differently by an ulp of |dn|,
//   which relative to t_num exceeds the checks' T_RTOL 1e-5 for hits closer
//   than ~1e-2 of the scene's extent; so this part stays exact.
// * p = o + t d, u = r1.p + d1 and v = r2.p + d2 are contracted to FMA and
//   p takes t from rcp.approx (within 2 ulps of the exact t).  That moves u
//   and v by a few ulps of |r1||p| (~2e-6 on the liver proxy),
//   which can flip only a hit within that distance of a triangle edge: the
//   neighbour then takes the ray (prim agreement, checked >= 0.99) or,
//   rarely, neither does (hit agreement, checked >= 0.9999).  t of a
//   triangle both take is the same bits, so |dt| = 0 there.
// * The candidate prefilter is conservative (see above) and the culling is
//   the same box test as the TPU kernel's, applied per ray.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTileT = 128;                       // triangles per chunk
constexpr int kThreads = 128;                     // threads per sweep block
constexpr int kRpt = 2;                           // rays owned per thread
constexpr int kMinBlocksPerSm = 8;                // register cap for ptxas
constexpr int kRaysPerBlock = kThreads * kRpt;
constexpr int kChunkF4 = kTileT * 16 / 4;         // float4s per chunk (512)
constexpr int kMergeThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kLimWiden = 1.000001f;            // prefilter margin
constexpr float kLimFloor = 1e-20f;               // keeps lim' * |n.d| normal

__device__ __forceinline__ void cp_async16(float4* dst, const float4* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The block's rays, in shared memory: the thread that tests a ray against a
// chunk is not the one that owns it.
struct BlockRays {
  float ox[kRaysPerBlock], oy[kRaysPerBlock], oz[kRaysPerBlock];
  float dx[kRaysPerBlock], dy[kRaysPerBlock], dz[kRaysPerBlock];
  float maxt[kRaysPerBlock], best_t[kRaysPerBlock], best_id[kRaysPerBlock];
};

__device__ __forceinline__ float ray_limit(const BlockRays& s, int i) {
  return fminf(s.best_t[i], s.maxt[i]);
}

// Entry distance of ray i into box c, +inf when it misses the box or the
// box lies behind it (the TPU kernel's slab test, the same operations).
__device__ __forceinline__ float box_near(const float* __restrict__ boxes,
                                          int c, const BlockRays& s, int i) {
  const float* b = boxes + 8 * c;
  const float lox = __ldg(b + 0), loy = __ldg(b + 1), loz = __ldg(b + 2);
  const float hix = __ldg(b + 3), hiy = __ldg(b + 4), hiz = __ldg(b + 5);
  // a padded chunk's box is empty (+inf min, -inf max), which the slab
  // test below would take for the whole space: its rows are all zero
  if (!(lox <= hix)) return CUDART_INF_F;
  const float ox = s.ox[i], oy = s.oy[i], oz = s.oz[i];
  const float dx = s.dx[i], dy = s.dy[i], dz = s.dz[i];
  const float eps = 1e-20f;
  const float idx = 1.0f / (fabsf(dx) > eps ? dx : eps);
  const float idy = 1.0f / (fabsf(dy) > eps ? dy : eps);
  const float idz = 1.0f / (fabsf(dz) > eps ? dz : eps);
  const float t0x = (lox - ox) * idx;
  const float t1x = (hix - ox) * idx;
  const float t0y = (loy - oy) * idy;
  const float t1y = (hiy - oy) * idy;
  const float t0z = (loz - oz) * idz;
  const float t1z = (hiz - oz) * idz;
  const float near = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                           fminf(t0z, t1z));
  const float far = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                          fmaxf(t0z, t1z));
  return (near <= far && far > 0.f) ? near : CUDART_INF_F;
}

__device__ __forceinline__ void stage_chunk(float4* dst,
                                            const float4* __restrict__ tris,
                                            int c) {
  const float4* src = tris + static_cast<size_t>(c) * kChunkF4;
  for (int i = threadIdx.x; i < kChunkF4; i += kThreads)
    cp_async16(dst + i, src + i);
  cp_async_commit();
}

// The Baldwin-Weber tests of one staged chunk against ray i, which enters
// the chunk's box, by a group of 2^g_shift lanes: lane g of the group tests
// rows g, g + 2^g_shift, ...; the group reduces its minimum under the
// in-chunk tie rule and its first lane updates the ray's best hit in shared
// memory.  `mask` holds the warp's lanes in this round.
__device__ __forceinline__ void test_chunk(const float4* __restrict__ tri,
                                           BlockRays& s, int i, int g,
                                           int g_shift, unsigned mask) {
  const float ox = s.ox[i], oy = s.oy[i], oz = s.oz[i];
  const float dx = s.dx[i], dy = s.dy[i], dz = s.dz[i];
  const float best_t = s.best_t[i];
  const float lim = fminf(best_t, s.maxt[i]);
  float lim_s = fmaxf(lim * kLimWiden, kLimFloor);
  float cmin = CUDART_INF_F, cid = -1.f;
#pragma unroll 2
  for (int j = g; j < kTileT; j += 1 << g_shift) {
    const float4 q0 = tri[4 * j];  // n xyz, dn
    const float ndir = __fadd_rn(__fadd_rn(__fmul_rn(q0.x, dx),
                                           __fmul_rn(q0.y, dy)),
                                 __fmul_rn(q0.z, dz));
    const float no = __fadd_rn(__fadd_rn(__fmul_rn(q0.x, ox),
                                         __fmul_rn(q0.y, oy)),
                               __fmul_rn(q0.z, oz));
    const float tnum = __fsub_rn(q0.w, no);
    const bool same_sign =
        ((__float_as_uint(tnum) ^ __float_as_uint(ndir)) >> 31) == 0u;
    if (!(fabsf(ndir) > 1e-12f && same_sign &&
          fabsf(tnum) <= lim_s * fabsf(ndir)))
      continue;
    const float4 q1 = tri[4 * j + 1];  // r1 xyz, d1
    const float4 q2 = tri[4 * j + 2];  // r2 xyz, d2
    // the hit point from an approximate t (rcp.approx, within 2 ulps): it
    // only decides u and v; the exact t below decides t > 0 and t < lim
    const float ta = __fdividef(tnum, ndir);
    const float px = fmaf(ta, dx, ox);
    const float py = fmaf(ta, dy, oy);
    const float pz = fmaf(ta, dz, oz);
    const float u = fmaf(q1.x, px, fmaf(q1.y, py, fmaf(q1.z, pz, q1.w)));
    const float v = fmaf(q2.x, px, fmaf(q2.y, py, fmaf(q2.z, pz, q2.w)));
    if (!(u >= 0.f && v >= 0.f && __fadd_rn(u, v) <= 1.f)) continue;
    const float t = __fmul_rn(tnum, __frcp_rn(ndir));
    if (!(t > 0.f && t < lim)) continue;
    const float id = tri[4 * j + 3].x;
    if (t < cmin || (t == cmin && id > cid)) {
      cmin = t;
      cid = id;
      lim_s = fmaxf(t * kLimWiden, kLimFloor);
    }
  }
  for (int off = (1 << g_shift) >> 1; off > 0; off >>= 1) {
    const float ot = __shfl_xor_sync(mask, cmin, off);
    const float oid = __shfl_xor_sync(mask, cid, off);
    if (ot < cmin || (ot == cmin && oid > cid)) {
      cmin = ot;
      cid = oid;
    }
  }
  // every hit of this chunk lies below best_t, so this is strict '<'
  if (g == 0 && cmin < best_t) {
    s.best_t[i] = cmin;
    s.best_id[i] = cid;
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
intersect_sweep_kernel(const float* __restrict__ rays, int n,
                       const float4* __restrict__ tris,
                       const float* __restrict__ boxes, int n_chunks,
                       int chunks_per_split, float* __restrict__ t_part,
                       int* __restrict__ prim_part) {
  __shared__ float4 s_tri[2][kChunkF4];
  __shared__ BlockRays s_ray;
  __shared__ int s_list[kRaysPerBlock];
  __shared__ int s_count[2];

  const int r0 = blockIdx.x * kRaysPerBlock;
  // thread t owns the block's rays t, t + 128, ...
#pragma unroll
  for (int k = 0; k < kRpt; ++k) {
    const int i = k * kThreads + threadIdx.x;
    const int r = r0 + i;
    const bool live = r < n;
    s_ray.ox[i] = live ? rays[r] : 0.f;
    s_ray.oy[i] = live ? rays[n + r] : 0.f;
    s_ray.oz[i] = live ? rays[2 * n + r] : 0.f;
    s_ray.dx[i] = live ? rays[3 * n + r] : 0.f;
    s_ray.dy[i] = live ? rays[4 * n + r] : 0.f;
    s_ray.dz[i] = live ? rays[5 * n + r] : 0.f;
    // dead lanes never enter a box nor hit
    s_ray.maxt[i] = live ? rays[6 * n + r] : -CUDART_INF_F;
    s_ray.best_t[i] = CUDART_INF_F;
    s_ray.best_id[i] = -1.f;
  }
  if (threadIdx.x < 2) s_count[threadIdx.x] = 0;
  __syncthreads();

  const int c0 = blockIdx.y * chunks_per_split;
  const int c1 = min(c0 + chunks_per_split, n_chunks);

  float near_next[kRpt];
  bool want = false;
#pragma unroll
  for (int k = 0; k < kRpt; ++k) {
    const int i = k * kThreads + threadIdx.x;
    near_next[k] = c0 < c1 ? box_near(boxes, c0, s_ray, i) : CUDART_INF_F;
    want |= near_next[k] < ray_limit(s_ray, i);
  }
  bool need = __syncthreads_or(want);
  if (need) stage_chunk(s_tri[0], tris, c0);

  const int lane = threadIdx.x & 31;
  for (int c = c0; c < c1; ++c) {
    const int slot = (c - c0) & 1;
    cp_async_wait_all();  // this thread's copies of chunk c have landed
    // publishes chunk c and the previous chunk's hits, and ends every read
    // of the other ring slot, the list and the other counter
    __syncthreads();
    float near[kRpt];
#pragma unroll
    for (int k = 0; k < kRpt; ++k) near[k] = near_next[k];
    if (need) {
      // the rays that still enter chunk c go on the block's list (in any
      // order: each ray appears once and is tested by one thread)
#pragma unroll
      for (int k = 0; k < kRpt; ++k) {
        const int i = k * kThreads + threadIdx.x;
        const bool enters = near[k] < ray_limit(s_ray, i);
        const unsigned mask = __ballot_sync(kFullMask, enters);
        int base = 0;
        if (lane == 0 && mask) base = atomicAdd(&s_count[slot], __popc(mask));
        base = __shfl_sync(kFullMask, base, 0);
        if (enters) s_list[base + __popc(mask & ((1u << lane) - 1u))] = i;
      }
    }
    want = false;
#pragma unroll
    for (int k = 0; k < kRpt; ++k) {
      const int i = k * kThreads + threadIdx.x;
      near_next[k] =
          c + 1 < c1 ? box_near(boxes, c + 1, s_ray, i) : CUDART_INF_F;
      want |= near_next[k] < ray_limit(s_ray, i);
    }
    // the list of chunk c is complete
    const bool need_next = __syncthreads_or(want);
    if (need_next) stage_chunk(s_tri[slot ^ 1], tris, c + 1);
    if (threadIdx.x == 0) s_count[slot ^ 1] = 0;  // next chunk's counter
    if (need) {
      // a short list spreads each ray over a group of lanes, so that the
      // block's threads share the chunk's tests
      const int len = s_count[slot];
      int g_shift = 0;
      while (g_shift < 5 && (len << (g_shift + 1)) <= kThreads) ++g_shift;
      const int slots = len << g_shift;
      for (int e = threadIdx.x; e < slots; e += kThreads) {
        const int act = min(32, slots - (e - lane));
        const unsigned mask = act == 32 ? kFullMask : (1u << act) - 1u;
        test_chunk(s_tri[slot], s_ray, s_list[e >> g_shift],
                   e & ((1 << g_shift) - 1), g_shift, mask);
      }
    }
    need = need_next;
  }
  __syncthreads();  // the last chunk's hits

  const size_t base = static_cast<size_t>(blockIdx.y) * n;
#pragma unroll
  for (int k = 0; k < kRpt; ++k) {
    const int i = k * kThreads + threadIdx.x;
    if (r0 + i < n) {
      t_part[base + r0 + i] = s_ray.best_t[i];
      prim_part[base + r0 + i] = static_cast<int>(s_ray.best_id[i]);
    }
  }
}

__global__ void __launch_bounds__(kMergeThreads)
intersect_merge_kernel(const float* __restrict__ t_part,
                       const int* __restrict__ prim_part, int n, int splits,
                       float* __restrict__ t_out, int* __restrict__ prim_out) {
  const int r = blockIdx.x * kMergeThreads + threadIdx.x;
  if (r >= n) return;
  float best_t = t_part[r];
  int best_prim = prim_part[r];
  for (int s = 1; s < splits; ++s) {
    const size_t i = static_cast<size_t>(s) * n + r;
    const float t = t_part[i];
    if (t < best_t) {  // strict: an earlier split keeps a tie
      best_t = t;
      best_prim = prim_part[i];
    }
  }
  t_out[r] = best_t;
  prim_out[r] = best_prim;
}

}  // namespace

// C ABI for ctypes.  Each launch goes on `stream` without synchronising and
// returns cudaGetLastError() (0 on success).

// Rays per sweep block and resident sweep blocks per SM on the current
// device (the wrapper sizes the split from them).
extern "C" int lr_intersect_config(int* rays_per_block, int* blocks_per_sm) {
  *rays_per_block = kRaysPerBlock;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, intersect_sweep_kernel, kThreads, 0));
}

// Partial closest hits of split s (chunks [s*cps, (s+1)*cps)) into
// t_part[s*n + r], prim_part[s*n + r]; with splits == 1 these are the
// results.
extern "C" int lr_intersect_sweep(const float* rays, int n, const float* tris,
                                  const float* boxes, int n_chunks,
                                  int chunks_per_split, int splits,
                                  float* t_part, int* prim_part,
                                  void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((n + kRaysPerBlock - 1) / kRaysPerBlock, splits);
  intersect_sweep_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      rays, n, reinterpret_cast<const float4*>(tris), boxes, n_chunks,
      chunks_per_split, t_part, prim_part);
  return static_cast<int>(cudaGetLastError());
}

// Walks the splits' partials in order with strict '<'.
extern "C" int lr_intersect_merge(const float* t_part, const int* prim_part,
                                  int n, int splits, float* t_out,
                                  int* prim_out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (n + kMergeThreads - 1) / kMergeThreads;
  intersect_merge_kernel<<<blocks, kMergeThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      t_part, prim_part, n, splits, t_out, prim_out);
  return static_cast<int>(cudaGetLastError());
}
