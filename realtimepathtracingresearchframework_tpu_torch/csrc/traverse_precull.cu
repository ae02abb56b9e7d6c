// Pre-cull traversal (K3) for Hopper: closest hit and any-hit on sorted
// queues, with the per-ray leaf cull fused in.
//
// Replaces the Pallas TPU kernel
// realtimepathtracingresearchframework_tpu/ops/traverse_pallas3.py::_kernel4
// (pallas_call at :1035; entries closest_hit_pallas4 :1063,
// occluded_pallas4 :1090) together with its XLA feeder leaf_masks_xla
// (:667), which built an (nb, Lpad) mask in device memory first. Its plain
// PyTorch version, which this kernel must equal bit for bit, is
// ops/traverse_flat.py::precull_leaf_masks + _flush.
//
// What it computes: as K2 (traverse_flat_cull.cu), but a leaf survives for
// a group of q lanes (one CUDA block) when ANY lane's own exact slab test of
// its segment [tmin, tmax] passes against the leaf box. That is the OR over
// the group of leaf_masks_xla's per-ray test, much tighter than K2's union
// packet on incoherent bounce and shadow queues, where one stray lane
// widens the union box for the whole group.
//
// Design: the feeder is fused. Each thread tests its own ray against every
// leaf box (the boxes are read by all lanes of a warp at once, a broadcast
// from L1); a warp ballot ORs the warp's verdicts and one lane marks the
// leaf in a shared flag array. The (N, Lpad) per-ray mask never exists and
// nothing is written between the cull and the flush. The survivors then go
// through the shared flush of flat_flush.cuh.
//
// What bounds it on this card: the flush's Moller-Trumbore arithmetic,
// about 54 flops per ray and triangle of every surviving leaf, plus the
// cull's ~25 flops per ray and leaf (every thread tests all leaves, 640 at
// 80k tris). The coherence sort upstream (the caller's compact) keeps the
// OR of a group's exact tests close to what each lane needs. Later work:
// double-buffer the staged rows, test leaves per warp instead of per block,
// and stop testing leaves behind a lane's nearest hit.

#include "flat_flush.cuh"

namespace {

using namespace rptr_flat;

template <bool kAnyHit>
__global__ void precull_kernel(const float* __restrict__ aabbs, int lpad,
                               int num_leaves, const float* __restrict__ rows,
                               int ls, const float* __restrict__ rays, int n,
                               float* __restrict__ out_t,
                               int* __restrict__ out_row,
                               float* __restrict__ out_u,
                               float* __restrict__ out_v,
                               unsigned char* __restrict__ out_blocked) {
  extern __shared__ int smem[];
  int* list = smem;                                     // lpad survivor ids
  int* flags = smem + lpad;                             // lpad leaf flags
  float* stage = reinterpret_cast<float*>(flags + lpad);  // 9 * ls floats
  __shared__ int count;

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  Lane r;
  r.load(rays, n, i);
  for (int l = threadIdx.x; l < num_leaves; l += blockDim.x) flags[l] = 0;
  if (threadIdx.x == 0) count = 0;
  const bool any_live = __syncthreads_or(r.live);

  // ---- fused feeder: each lane's exact slab test against every leaf
  // (traverse_pallas3.py:700-714), OR-ed over the block
  if (any_live) {
    const float ix = safe_inv(r.dx), iy = safe_inv(r.dy), iz = safe_inv(r.dz);
    for (int l = 0; l < num_leaves; ++l) {
      bool hit = false;
      if (r.live) {
        const float lox = __ldg(aabbs + l), hix = __ldg(aabbs + 3 * lpad + l);
        const float loy = __ldg(aabbs + lpad + l), hiy = __ldg(aabbs + 4 * lpad + l);
        const float loz = __ldg(aabbs + 2 * lpad + l), hiz = __ldg(aabbs + 5 * lpad + l);
        float tn = r.tmin, tf = r.tmax;
        float t0 = (lox - r.ox) * ix, t1 = (hix - r.ox) * ix;
        tn = fmaxf(tn, fminf(t0, t1));
        tf = fminf(tf, fmaxf(t0, t1));
        t0 = (loy - r.oy) * iy;
        t1 = (hiy - r.oy) * iy;
        tn = fmaxf(tn, fminf(t0, t1));
        tf = fminf(tf, fmaxf(t0, t1));
        t0 = (loz - r.oz) * iz;
        t1 = (hiz - r.oz) * iz;
        tn = fmaxf(tn, fminf(t0, t1));
        tf = fminf(tf, fmaxf(t0, t1));
        hit = tn <= tf && lox <= hix;
      }
      if (__ballot_sync(0xffffffffu, hit) && lane == 0) flags[l] = 1;
    }
  }
  __syncthreads();
  for (int l = threadIdx.x; l < num_leaves; l += blockDim.x)
    if (flags[l]) list[atomicAdd(&count, 1)] = l;
  __syncthreads();

  Best b;
  flush<kAnyHit>(rows, ls, list, count, stage, r, b);
  write_out<kAnyHit>(i, b, out_t, out_row, out_u, out_v, out_blocked);
}

}  // namespace

// Plain C entry for ctypes; the same contract as rptr_traverse_flat_cull.
extern "C" int rptr_traverse_precull(
    const float* aabbs, int lpad, int num_leaves, const float* rows,
    int leaf_size, const float* rays, int n, int q, int any_hit, float* out_t,
    int* out_row, float* out_u, float* out_v, unsigned char* out_blocked,
    void* stream) {
  if (n <= 0) return 0;
  if (q <= 0 || q > 1024 || q % 32 || n % q) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(lpad, leaf_size, true);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit)
    precull_kernel<true><<<n / q, q, smem, s>>>(
        aabbs, lpad, num_leaves, rows, leaf_size, rays, n, out_t, out_row,
        out_u, out_v, out_blocked);
  else
    precull_kernel<false><<<n / q, q, smem, s>>>(
        aabbs, lpad, num_leaves, rows, leaf_size, rays, n, out_t, out_row,
        out_u, out_v, out_blocked);
  return static_cast<int>(cudaGetLastError());
}
