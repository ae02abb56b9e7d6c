// Flat-cull traversal (K2) for Hopper: closest hit and any-hit, no tree walk.
//
// Replaces the Pallas TPU kernel
// realtimepathtracingresearchframework_tpu/ops/traverse_pallas3.py::_kernel3
// (pallas_call at :526; entries closest_hit_pallas3 :612, occluded_pallas3
// :638). Its plain PyTorch version, which this kernel must equal bit for
// bit, is ops/traverse_flat.py::flat_leaf_masks + _flush.
//
// What it computes: the rays arrive as one packed (8, n) operand [ro3, rd3,
// tmin, tmax]; every group of q consecutive lanes (one CUDA block, q =
// blockDim.x) reduces its packet bounds over its live lanes (origin box,
// inverse-direction box, min tmin, max tmax, as block_bounds does), tests
// that union packet against every leaf AABB with the conservative interval
// test of _kernel3 (traverse_pallas3.py:187-226), and flushes the surviving
// leaves with Moller-Trumbore (flat_flush.cuh). A leaf any lane's segment
// pierces always survives, so the closest hit (t, row, u, v) or blocked
// flag equals the resident walk's (K1) exactly. The mode is per block:
// blocks from ``shadow_from`` on take the any-hit exit, so one launch can
// carry a closest queue in its first blocks and a shadow queue after it
// (the merged mode, traverse_pallas3.closest_and_occluded_pallas3 :1119);
// any-hit lane i writes blocked[i - shadow_from * q].
//
// Design: the TPU kernel's group-major retile, 4-bit-per-leaf mask row,
// SMEM DMA and scalar scan exist for the TPU's vector and scalar units and
// are not carried over. Here one block is one group: a warp-shuffle
// reduction for the packet bounds, one thread per leaf for the broad phase
// (leaf boxes read coalesced, columns of the (16, Lpad) array), a shared
// survivor list, then one leaf at a time staged in shared memory (4.6 KB at
// leaf 128) while every thread runs Moller-Trumbore on its own ray.
//
// What bounds it on this card: the flush's arithmetic, about 54 flops per
// ray and triangle (traverse_pallas2._mt_leaf), multiplied by how loose the
// union box is: every lane of a group tests every row of every leaf that
// any lane of the group might need, and one lane's stray direction widens
// the inverse-direction interval for all. Coherent queues (camera
// primaries) keep the union tight; that is where the renderer uses K2.
// The stage-then-compute loop also leaves the SM idle during each row load;
// later work can double-buffer the stage (cp.async or TMA), cap t per group
// to skip leaves behind the nearest hit, and shrink groups.

#include "flat_flush.cuh"

namespace {

using namespace rptr_flat;

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// kMode: 0 every block closest, 1 every block any-hit, 2 blocks from
// shadow_from on any-hit (the merged launch)
template <int kMode>
__global__ void flat_cull_kernel(const float* __restrict__ aabbs, int lpad,
                                 int num_leaves, const float* __restrict__ rows,
                                 int ls, const float* __restrict__ rays, int n,
                                 int shadow_from, float* __restrict__ out_t,
                                 int* __restrict__ out_row,
                                 float* __restrict__ out_u,
                                 float* __restrict__ out_v,
                                 unsigned char* __restrict__ out_blocked) {
  extern __shared__ int smem[];
  int* list = smem;                                    // lpad survivor ids
  float* stage = reinterpret_cast<float*>(smem + lpad);  // 9 * ls row floats
  __shared__ float part[14][32];  // per-warp partial packet bounds
  __shared__ float pb[14];        // the group's packet bounds
  __shared__ int count;

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  Lane r;
  r.load(rays, n, i);

  // ---- packet bounds over the group's live lanes (block_bounds order:
  // 0-2 origin min, 3-5 origin max, 6-8 inv-dir min, 9-11 inv-dir max,
  // 12 tmin min, 13 tmax max); min and max are exact in any order
  const float o[3] = {r.ox, r.oy, r.oz};
  const float iv[3] = {safe_inv(r.dx), safe_inv(r.dy), safe_inv(r.dz)};
  float v[14];
  for (int k = 0; k < 3; ++k) {
    v[k] = warp_min(r.live ? o[k] : kBig);
    v[3 + k] = warp_max(r.live ? o[k] : -kBig);
    v[6 + k] = warp_min(r.live ? iv[k] : kBig);
    v[9 + k] = warp_max(r.live ? iv[k] : -kBig);
  }
  v[12] = warp_min(r.live ? r.tmin : kBig);
  v[13] = warp_max(r.live ? r.tmax : -kBig);
  if (lane == 0)
    for (int k = 0; k < 14; ++k) part[k][warp] = v[k];
  if (threadIdx.x == 0) count = 0;
  __syncthreads();
  if (threadIdx.x < 14) {
    const int k = threadIdx.x;
    const bool is_min = k < 3 || (k >= 6 && k < 9) || k == 12;
    float acc = part[k][0];
    for (int w = 1; w < nwarps; ++w)
      acc = is_min ? fminf(acc, part[k][w]) : fmaxf(acc, part[k][w]);
    pb[k] = acc;
  }
  __syncthreads();

  // ---- broad phase: the union packet against every leaf box, one thread
  // per leaf (traverse_pallas3.py:187-226). An all-dead group (tmax max <=
  // tmin min) keeps no leaf.
  const float tlo = pb[12], thi = pb[13];
  if (thi > tlo) {
    for (int l = threadIdx.x; l < num_leaves; l += blockDim.x) {
      float lb = tlo, ub = thi;
      bool expand_ok = true;
      for (int k = 0; k < 3; ++k) {
        const float olo = pb[k], ohi = pb[3 + k];
        const float ilo = pb[6 + k], ihi = pb[9 + k];
        const float bmn = aabbs[k * lpad + l], bmx = aabbs[(3 + k) * lpad + l];
        const float alo = bmn - ohi, ahi = bmn - olo;
        const float blo = bmx - ohi, bhi = bmx - olo;
        const float t0lo = fminf(fminf(alo * ilo, alo * ihi), fminf(ahi * ilo, ahi * ihi));
        const float t0hi = fmaxf(fmaxf(alo * ilo, alo * ihi), fmaxf(ahi * ilo, ahi * ihi));
        const float t1lo = fminf(fminf(blo * ilo, blo * ihi), fminf(bhi * ilo, bhi * ihi));
        const float t1hi = fmaxf(fmaxf(blo * ilo, blo * ihi), fmaxf(bhi * ilo, bhi * ihi));
        lb = fmaxf(lb, fminf(t0lo, t1lo));
        ub = fminf(ub, fmaxf(t0hi, t1hi));
        expand_ok = expand_ok && (fmaxf(alo, -bhi) <= thi);
      }
      if (lb <= ub && expand_ok) list[atomicAdd(&count, 1)] = l;
    }
  }
  __syncthreads();

  // block-uniform, so the flush's barriers are reached by every thread
  const bool shadow =
      kMode == 1 || (kMode == 2 && static_cast<int>(blockIdx.x) >= shadow_from);
  Best b;
  if (shadow) {
    flush<true>(rows, ls, list, count, stage, r, b);
    write_out<true>(i - shadow_from * static_cast<int>(blockDim.x), b, out_t,
                    out_row, out_u, out_v, out_blocked);
  } else {
    flush<false>(rows, ls, list, count, stage, r, b);
    write_out<false>(i, b, out_t, out_row, out_u, out_v, out_blocked);
  }
}

}  // namespace

// Plain C entry for ctypes. ``rays`` is (8, n) f32, n a multiple of q; one
// block of q threads per group. Blocks from ``shadow_from`` on run the
// any-hit mode and write ``blocked`` (n - shadow_from * q flags), the
// blocks before it t, row, u, v (their lanes' worth): a closest launch is
// shadow_from >= n / q, an any-hit launch 0. Launches on ``stream`` and
// returns cudaGetLastError() (0 = launched). The caller allocates every
// output.
extern "C" int rptr_traverse_flat_cull(
    const float* aabbs, int lpad, int num_leaves, const float* rows,
    int leaf_size, const float* rays, int n, int q, int shadow_from,
    float* out_t, int* out_row, float* out_u, float* out_v,
    unsigned char* out_blocked, void* stream) {
  if (n <= 0) return 0;
  if (q <= 0 || q > 1024 || q % 32 || n % q || shadow_from < 0)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(lpad, leaf_size);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = n / q;
  if (shadow_from >= grid)
    flat_cull_kernel<0><<<grid, q, smem, s>>>(
        aabbs, lpad, num_leaves, rows, leaf_size, rays, n, grid, out_t,
        out_row, out_u, out_v, out_blocked);
  else if (shadow_from == 0)
    flat_cull_kernel<1><<<grid, q, smem, s>>>(
        aabbs, lpad, num_leaves, rows, leaf_size, rays, n, 0, out_t, out_row,
        out_u, out_v, out_blocked);
  else
    flat_cull_kernel<2><<<grid, q, smem, s>>>(
        aabbs, lpad, num_leaves, rows, leaf_size, rays, n, shadow_from, out_t,
        out_row, out_u, out_v, out_blocked);
  return static_cast<int>(cudaGetLastError());
}
