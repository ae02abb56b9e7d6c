// The rptr.shade stage of a bounce as two fused kernels: shade_hit and
// shade_scatter.
//
// Replaces no TPU kernel. The reference shades in XLA, which fuses the
// per-lane arithmetic of a bounce itself; the port ran it as eager PyTorch,
// some 1,500-2,500 elementwise launches a bounce, each an 8 MB pass over a
// chunk's planar carry. These two kernels take the place of that eager code
// (ops/shade.py), whose plain versions, shade_hit_plain and
// shade_scatter_plain, they must equal bit for bit.
//
// shade_hit: everything visit_hit does after the traversal: the miss and its
// sky term (Hosek or Preetham sky, the sun cap with its MIS weight), the hit
// attributes from the (ATTR_W, R) attribute table (edges, interpolated and
// geometric normals, the approximate solid angle), the (MAT_W, M) material
// row, the two-sided flip, total_t, on textured scenes the footprint, the mip
// and the three bilinear atlas samples (base colour, specular/roughness,
// normal map), the emitter's MIS term, bounce_count and rays, and in the
// wavefront variant the empty deferred shadow queue. shade_scatter: the
// glossy-only mask, the GLTF BSDF sample in the shading frame (the BSDF value
// and its MIS pdf of the sampled direction included), termination and
// throughput, the footprint's transport, the next ray (the wavefront's origin
// rule included) and Russian roulette. The RNG draws stay in PyTorch; both
// kernels take the drawn samples.
//
// What bounds it on this card: bytes. A lane-visit reads the carry, the hit,
// the attribute and material rows and up to 12 texels, and writes the carry
// and the hit context: about 0.5-0.6 KB, so some 0.2 us a thousand lanes at
// 3.35 TB/s. The arithmetic, a few hundred flops and a dozen libm calls a
// lane, is far below the card's rate.
//
// Design: one thread a lane, 256 threads a block. The carry is planar (one
// array a field), so a warp's loads and stores of a field are coalesced; the
// table rows are gathered once a lane (one load a column), and each texel
// once a sample. No shared memory, no atomics: every output is the lane's.
//
// Parity with the plain version (PyTorch's elementwise kernels on the card):
// every expression keeps the plain code's operation order, with no FMA
// contraction (--fmad=false) and IEEE division and square root (a Python
// float over a tensor is the tensor's reciprocal times the float, as
// Tensor.__rtruediv__ computes it); the same
// libm functions torch's kernels call (expf, powf, log2f, acosf, cosf, sinf,
// sqrtf, floorf); torch.round is rintf (half to even); clamp, maximum and
// minimum propagate NaN as torch's do; a Python float constant is a double
// rounded to f32 (PYF); a tensor divided by a Python float on the card is a
// product with the constant's reciprocal rounded to f32, as torch's CUDA
// division by a CPU scalar is (DIV_SCALAR; measured on the H100 with torch
// 2.11); integers stay integers (table columns are
// float values, converted as .to() converts them).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false (kernels/build.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

// a Python float as torch casts it for an f32 tensor: the double, rounded
#define PYF(x) (static_cast<float>(x))
// tensor / (Python float) on the card: torch multiplies by the constant's
// reciprocal, taken in double and rounded to f32
#define DIV_SCALAR(a, c) ((a) * PYF(1.0 / (c)))

constexpr double kPi = 3.141592653589793;
constexpr double kM1Pi = 1.0 / kPi;  // bsdf_gltf.M_1_PI

// The table layout this file is compiled for: ops/shade_common.py's LAYOUT
// holds the same numbers under these names, rptr_shade_layout reports them,
// and ops/shade.py refuses to launch a library that reports others. The
// attribute table is (kAttrW, R), the material table (kMatW, M), both f32
// with integer columns as float values; the atlas descriptor (T, kMaxMips, 3)
// int32 (offset, width, height).
constexpr int kAttrW = 32, kMatW = 16, kMaxMips = 14;
constexpr int kAE1 = 0, kAE2 = 3, kAN0 = 6, kAN1 = 9, kAN2 = 12;
constexpr int kAUV0 = 15, kAUV1 = 17, kAUV2 = 19, kATan = 21, kADens = 25;
constexpr int kAMid = 26;
constexpr int kMBase = 0, kMRough = 3, kMSpec = 4, kMMetal = 5, kMIor = 6;
constexpr int kMStrans = 7, kMEmit = 8, kMFlags = 9, kMBctex = 10;
constexpr int kMSptex = 11, kMNmtex = 12;
constexpr int kOnesided = 0x02;  // BASE_MATERIAL_ONESIDED
constexpr double kRayEpsilon = 5.0e-6;  // vulkan/gpu_params.glsl:28

// ---------------------------------------------------------------------------
// Operand tables: the order of ops/shade.py's HIT_IN + HIT_TABLES +
// HIT_FLOAT_OUT + HIT_OTHER_OUT and SCATTER_IN + SCATTER_FLOAT_OUT +
// SCATTER_OTHER_OUT
// ---------------------------------------------------------------------------

enum HitPtr {
  H_ROX, H_ROY, H_ROZ, H_RDX, H_RDY, H_RDZ, H_ILX, H_ILY, H_ILZ, H_THX, H_THY,
  H_THZ, H_ACTIVE, H_PREV_PDF, H_BOUNCE, H_TOTAL_T, H_RAYS, H_T, H_TRI, H_U,
  H_V, H_FA, H_FB, H_FC,
  // tables
  H_ATTR, H_MAT, H_PEREZ, H_ZENITH, H_SUN_DIR, H_SUN_COS, H_SUN_RAD, H_SCALE,
  H_HCFG, H_HRAD, H_TEXELS, H_DESC, H_NUM_MIPS, H_SRGB,
  // f32 outputs
  O_ILX, O_ILY, O_ILZ, O_TOTAL_T, O_PX, O_PY, O_PZ, O_NX, O_NY, O_NZ, O_GX,
  O_GY, O_GZ, O_WX, O_WY, O_WZ, O_BX, O_BY, O_BZ, O_METALLIC, O_SPECULAR,
  O_ROUGHNESS, O_IOR, O_STRANS, O_PEND_ZERO, O_PEND_ONE,
  // other outputs
  O_ACTIVE, O_BOUNCE, O_RAYS, O_ONESIDED, O_PEND_TRACED,
  H_NPTR
};

enum ScatterPtr {
  S_ROX, S_ROY, S_ROZ, S_RDX, S_RDY, S_RDZ, S_THX, S_THY, S_THZ, S_ACTIVE,
  S_PREV_PDF, S_BOUNCE, S_TOTAL_T, S_FA, S_FB, S_FC, S_PX, S_PY, S_PZ, S_NX,
  S_NY, S_NZ, S_GX, S_GY, S_GZ, S_WX, S_WY, S_WZ, S_BX, S_BY, S_BZ, S_TCX,
  S_TCY, S_TCZ, S_METALLIC, S_ROUGHNESS, S_IOR, S_STRANS, S_ONESIDED, S_DIR0,
  S_DIR1, S_LOBE0, S_RR,
  // f32 outputs
  T_ROX, T_ROY, T_ROZ, T_RDX, T_RDY, T_RDZ, T_TMIN, T_THX, T_THY, T_THZ,
  T_PREV_PDF, T_FA, T_FB, T_FC,
  // other outputs
  T_ACTIVE,
  S_NPTR
};

struct HitArgs {
  const void* p[H_NPTR];
  long long attr_stride;  // R: the attribute table's row length
  long long mat_stride;   // M
  int n;
  int hosek;      // the sky's Hosek state (else Preetham)
  int wavefront;  // write the empty deferred shadow queue
  float bump_scale;
  float light_n;  // the light count (or bins) of approx_tri_lights_pdf
};

struct ScatterArgs {
  const void* p[S_NPTR];
  int n;
  int transmission;  // cfg.has_transmission
  int wavefront;
  int glossy_only;
  int rr_path_depth;
};

template <typename T>
__device__ __forceinline__ T ld(const void* p, int i) {
  return static_cast<const T*>(p)[i];
}

template <typename T>
__device__ __forceinline__ void st(const void* p, int i, T v) {
  static_cast<T*>(const_cast<void*>(p))[i] = v;
}

// ---------------------------------------------------------------------------
// torch's elementwise semantics
// ---------------------------------------------------------------------------

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}

__device__ __forceinline__ float clamp2(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float maximum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

struct V {
  float x, y, z;
};

__device__ __forceinline__ V operator+(V a, V b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V operator-(V a, V b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V operator*(V a, V b) {
  return {a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ V operator*(V a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ V operator-(V a) { return {-a.x, -a.y, -a.z}; }

__device__ __forceinline__ float dot(V a, V b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ V cross(V a, V b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ float length(V a) { return sqrtf(dot(a, a)); }

__device__ __forceinline__ V normalize(V a, float eps) {
  const float inv = 1.0f / clamp_min(length(a), eps);
  return {a.x * inv, a.y * inv, a.z * inv};
}

__device__ __forceinline__ V normalize(V a) { return normalize(a, PYF(1e-20)); }

__device__ __forceinline__ V vabs(V a) {
  return {fabsf(a.x), fabsf(a.y), fabsf(a.z)};
}

// GLSL reflect(i, n) = i - 2 dot(n, i) n (vec3.reflect)
__device__ __forceinline__ V reflect(V i, V n) {
  const float d2 = 2.0f * dot(n, i);
  return {i.x - d2 * n.x, i.y - d2 * n.y, i.z - d2 * n.z};
}

// GLSL refract (vec3.refract): 0 on total internal reflection
__device__ __forceinline__ V refract(V i, V n, float eta) {
  const float n_dot_i = dot(n, i);
  const float k = 1.0f - eta * eta * (1.0f - n_dot_i * n_dot_i);
  const bool tir = k < 0.0f;
  const float c = eta * n_dot_i + sqrtf(clamp_min(k, 0.0f));
  const V r = {eta * i.x - c * n.x, eta * i.y - c * n.y, eta * i.z - c * n.z};
  return tir ? V{0.0f, 0.0f, 0.0f} : r;
}

// nee.ortho_frame_v
__device__ __forceinline__ void ortho_frame(V n, V& vx, V& vy) {
  const bool c1 = fabsf(n.x) < PYF(0.6);
  const bool c2 = fabsf(n.y) < PYF(0.6);
  const bool c3 = fabsf(n.z) < PYF(0.6);
  const V y0 = {(c1 || !(c2 || c3)) ? 1.0f : 0.0f, (!c1 && c2) ? 1.0f : 0.0f,
                (!c1 && !c2 && c3) ? 1.0f : 0.0f};
  vx = normalize(cross(y0, n));
  vy = normalize(cross(n, vx));
}

// nee.nee_mis_heuristic(1, pdf_f, 1, pdf_g)
__device__ __forceinline__ float mis(float pdf_f, float pdf_g) {
  const float f = pdf_f * 1.0f;
  const float g = pdf_g * 1.0f;
  return f / clamp_min(f + g, PYF(1e-30));
}

// ---------------------------------------------------------------------------
// Sky (models/sky.py::sky_radiance_v, integrator._sky_illum)
// ---------------------------------------------------------------------------

__device__ float hosek_channel(const float* cfg, float rad, float cos_theta,
                               float gamma, float cos_gamma) {
  const float c0 = cfg[0], c1 = cfg[3], c2 = cfg[6], c3 = cfg[9], c4 = cfg[12];
  const float c5 = cfg[15], c6 = cfg[18], c7 = cfg[21], c8 = cfg[24];
  const float exp_m = expf(c4 * gamma);
  const float ray_m = cos_gamma * cos_gamma;
  const float mie_m =
      (1.0f + cos_gamma * cos_gamma) /
      powf(clamp_min((1.0f + c8 * c8) - 2.0f * c8 * cos_gamma, PYF(1e-12)),
           PYF(1.5));
  const float zenith = sqrtf(cos_theta);
  const float coeffs =
      (1.0f + c0 * expf(c1 / (cos_theta + PYF(0.01)))) *
      (c2 + c3 * exp_m + c5 * ray_m + c6 * mie_m + c7 * zenith);
  return coeffs * rad * PYF(0.01);
}

__device__ float perez(const float* k, float cos_theta, float gamma,
                       float cos_gamma) {
  const float a = k[0], b = k[1], c = k[2], d = k[3], e = k[4];
  return (1.0f + a * expf(b / clamp_min(cos_theta, PYF(0.01)))) *
         (1.0f + c * expf(d * gamma) + e * cos_gamma * cos_gamma);
}

__device__ V sky_radiance(const HitArgs& a, V d) {
  const float* sd = static_cast<const float*>(a.p[H_SUN_DIR]);
  const float scale = ld<float>(a.p[H_SCALE], 0);
  const float y = d.y;
  const float ca = clamp_min(1.0f - fabsf(y), 0.0f);
  const float ca2 = ca * ca;
  const float ocean = y <= 0.0f ? PYF(0.7) * (ca * (ca2 * ca2)) : 1.0f;
  const float ay = fabsf(y);
  const float inv =
      1.0f / sqrtf(clamp_min(d.x * d.x + ay * ay + d.z * d.z, PYF(1e-40)));
  const float mx = d.x * inv, my = ay * inv, mz = d.z * inv;
  const float cos_theta = clamp2(my, 0.0f, 1.0f);
  const float cos_gamma =
      clamp2(mx * sd[0] + my * sd[1] + mz * sd[2], -1.0f, 1.0f);
  const float s = scale * ocean;
  if (a.hosek) {
    const float* cfg = static_cast<const float*>(a.p[H_HCFG]);
    const float* rad = static_cast<const float*>(a.p[H_HRAD]);
    const float h_gamma = acosf(cos_theta);
    const float r = hosek_channel(cfg + 0, rad[0], cos_theta, h_gamma, cos_gamma);
    const float g = hosek_channel(cfg + 1, rad[1], cos_theta, h_gamma, cos_gamma);
    const float b = hosek_channel(cfg + 2, rad[2], cos_theta, h_gamma, cos_gamma);
    return {r * s, g * s, b * s};
  }
  const float* pz = static_cast<const float*>(a.p[H_PEREZ]);
  const float* zen = static_cast<const float*>(a.p[H_ZENITH]);
  const float gamma = acosf(cos_gamma);
  const float theta_s = acosf(clamp2(sd[1], 0.0f, 1.0f));
  const float cos_theta_s = cosf(theta_s);
  float ratio[3];
  for (int i = 0; i < 3; ++i) {
    const float f = perez(pz + 5 * i, cos_theta, gamma, cos_gamma);
    const float f0 = perez(pz + 5 * i, 1.0f, theta_s, cos_theta_s);
    ratio[i] = zen[i] * f / clamp_min(f0, PYF(1e-9));
  }
  const float lum = ratio[0];
  const float x = ratio[1];
  const float yc = clamp_min(ratio[2], PYF(1e-6));
  const float X = x / yc * lum;
  const float Z = (1.0f - x - yc) / yc * lum;
  // sky._XYZ_TO_SRGB in f32
  const float r = clamp_min(PYF(3.2404542) * X + PYF(-1.5371385) * lum +
                                PYF(-0.4985314) * Z, 0.0f) * s;
  const float g = clamp_min(PYF(-0.9692660) * X + PYF(1.8760108) * lum +
                                PYF(0.0415560) * Z, 0.0f) * s;
  const float b = clamp_min(PYF(0.0556434) * X + PYF(-0.2040259) * lum +
                                PYF(1.0572252) * Z, 0.0f) * s;
  return {r, g, b};
}

// nee.sun_dir_pdf
__device__ __forceinline__ float sun_dir_pdf(float cos_radius) {
  return 1.0f / (PYF(2.0 * kPi) * (1.0f - cos_radius));
}

__device__ V sky_illum(const HitArgs& a, V rd, float prev_pdf) {
  const V atm = vabs(sky_radiance(a, rd));
  const float* sd = static_cast<const float*>(a.p[H_SUN_DIR]);
  const float* sr = static_cast<const float*>(a.p[H_SUN_RAD]);
  const float cos_angle = ld<float>(a.p[H_SUN_COS], 0);
  // integrator._ocean
  const float oa = clamp_min(1.0f - fabsf(rd.y), 0.0f);
  const float oa2 = oa * oa;
  const float ocean = rd.y <= 0.0f ? PYF(0.7) * (oa * (oa2 * oa2)) : 1.0f;
  const V dm = normalize(V{rd.x, fabsf(rd.y), rd.z});
  const bool in_cap = (dm.x * sd[0] + dm.y * sd[1] + dm.z * sd[2]) >= cos_angle;
  const V sun = in_cap ? V{sr[0] * ocean, sr[1] * ocean, sr[2] * ocean}
                       : V{0.0f, 0.0f, 0.0f};
  const float light_pdf = sr[3] * sun_dir_pdf(cos_angle);
  const float w = mis(prev_pdf, light_pdf);
  return atm + vabs(sun) * w;
}

// ---------------------------------------------------------------------------
// Footprint (integrator._footprint_to_dpdxy_v, _reflect_footprint_v)
// ---------------------------------------------------------------------------

__device__ void footprint_to_dpdxy(V rd, float fa, float fb, float fc, V& dpdx,
                                   V& dpdy) {
  const float B = fa + fb;
  const float C = fa * fb - fc * fc;
  const float D = sqrtf(clamp_min(B * B * PYF(0.25) - C, 0.0f));
  const float ev0 = PYF(0.5) * B - D;
  const float ev1 = PYF(0.5) * B + D;
  const bool use = fabsf(fc) > PYF(3.0e-39);
  const float x0x = use ? fc : 1.0f;
  const float x0y = use ? ev0 - fa : 0.0f;
  const float x1x = use ? ev1 - fb : 0.0f;
  const float x1y = use ? fc : 1.0f;
  const float inv0 = 1.0f / clamp_min(sqrtf(x0x * x0x + x0y * x0y), PYF(1e-30));
  const float inv1 = 1.0f / clamp_min(sqrtf(x1x * x1x + x1y * x1y), PYF(1e-30));
  const float s0 = sqrtf(clamp_min(ev0, 0.0f)) * inv0;
  const float s1 = sqrtf(clamp_min(ev1, 0.0f)) * inv1;
  V t, b;
  ortho_frame(rd, t, b);
  dpdx = {(t.x * x0x + b.x * x0y) * s0, (t.y * x0x + b.y * x0y) * s0,
          (t.z * x0x + b.z * x0y) * s0};
  dpdy = {(t.x * x1x + b.x * x1y) * s1, (t.y * x1x + b.y * x1y) * s1,
          (t.z * x1x + b.z * x1y) * s1};
}

__device__ void reflect_footprint(V w_i, V rd, float fa, float fb, float fc,
                                  float& oa, float& ob, float& oc) {
  const V n = normalize(w_i - rd);
  V ts, bs, td, bd;
  ortho_frame(rd, ts, bs);
  const V rt = ts - n * (2.0f * dot(n, ts));
  const V rb = bs - n * (2.0f * dot(n, bs));
  ortho_frame(w_i, td, bd);
  const float t00 = dot(td, rt), t01 = dot(td, rb);
  const float t10 = dot(bd, rt), t11 = dot(bd, rb);
  const float m00 = t00 * fa + t01 * fc;
  const float m01 = t00 * fc + t01 * fb;
  const float m10 = t10 * fa + t11 * fc;
  const float m11 = t10 * fc + t11 * fb;
  oa = m00 * t00 + m01 * t01;
  ob = m10 * t10 + m11 * t11;
  oc = m00 * t10 + m01 * t11;
}

// ---------------------------------------------------------------------------
// Texture atlas (texture_atlas.sample_atlas): bilinear wrap sample, sRGB
// linearised after filtering
// ---------------------------------------------------------------------------

__device__ __forceinline__ long long rem_floor(long long a, long long b) {
  long long r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

__device__ __forceinline__ float texel(const int* texels, long long idx, int s) {
  return static_cast<float>((texels[idx] >> s) & 0xFF) * PYF(1.0 / 255.0);
}

__device__ __forceinline__ float srgb_lin(float c) {
  return c <= PYF(0.04045) ? DIV_SCALAR(c, 12.92)
                           : powf(DIV_SCALAR(c + PYF(0.055), 1.055), PYF(2.4));
}

// rgb of the sample of texture tid (>= 0) at uv and mip level ``mip``
__device__ V sample_atlas(const HitArgs& a, int tid, float u, float v, float mip) {
  const int* desc = static_cast<const int*>(a.p[H_DESC]);
  const int* num_mips = static_cast<const int*>(a.p[H_NUM_MIPS]);
  const bool* srgb = static_cast<const bool*>(a.p[H_SRGB]);
  const int* texels = static_cast<const int*>(a.p[H_TEXELS]);
  const long long mip_r = static_cast<long long>(rintf(mip));
  const long long nm = num_mips[tid];
  long long m = mip_r < 0 ? 0 : mip_r;
  if (nm - 1 < m) m = nm - 1;
  const int* dd = desc + (static_cast<long long>(tid) * kMaxMips + m) * 3;
  const long long off = dd[0], w = dd[1], h = dd[2];
  const float wf = static_cast<float>(w);
  const float hf = static_cast<float>(h);
  const float x = u * wf - PYF(0.5);
  const float y = v * hf - PYF(0.5);
  const long long x0 = static_cast<long long>(floorf(x));
  const long long y0 = static_cast<long long>(floorf(y));
  const float fx = x - static_cast<float>(x0);
  const float fy = y - static_cast<float>(y0);
  const long long x0w = rem_floor(x0, w), y0w = rem_floor(y0, h);
  const long long x1w = rem_floor(x0 + 1, w), y1w = rem_floor(y0 + 1, h);
  const long long i00 = off + y0w * w + x0w, i10 = off + y0w * w + x1w;
  const long long i01 = off + y1w * w + x0w, i11 = off + y1w * w + x1w;
  const float gx = 1.0f - fx, gy = 1.0f - fy;
  float out[3];
  for (int k = 0; k < 3; ++k) {
    const int s = 8 * k;
    out[k] = texel(texels, i00, s) * gx * gy + texel(texels, i10, s) * fx * gy +
             texel(texels, i01, s) * gx * fy + texel(texels, i11, s) * fx * fy;
  }
  if (srgb[tid]) {
    for (int k = 0; k < 3; ++k) out[k] = srgb_lin(out[k]);
  }
  return {out[0], out[1], out[2]};
}

// ---------------------------------------------------------------------------
// GLTF BSDF (ops/bsdf_gltf.py), thin transmission off
// ---------------------------------------------------------------------------

struct Mat {
  V base;
  V tcolor;  // transmission colour
  float metallic, roughness, ior, strans;
  bool onesided;
};

__device__ __forceinline__ float schlick_weight(float c) {
  const float x = clamp2(1.0f - c, 0.0f, 1.0f);
  const float x2 = x * x;
  return x2 * x2 * x;
}

__device__ __forceinline__ float gltf_schlick_weight(float o_dot_h, float ior) {
  const float f = schlick_weight(o_dot_h);
  const float cos_critical = sqrtf(clamp_min(1.0f - ior * ior, 0.0f));
  const float fix = clamp_max(
      (1.0f - o_dot_h) / clamp_min(1.0f - cos_critical, PYF(1e-9)), 1.0f);
  return ior < 1.0f ? f + (1.0f - f) * fix : f;
}

__device__ __forceinline__ float gtr_2(float cos_theta_h, float alpha) {
  const float a2 = alpha * alpha;
  const float d = 1.0f + (a2 - 1.0f) * cos_theta_h * cos_theta_h;
  return PYF(kM1Pi) * a2 / (d * d);
}

__device__ __forceinline__ float smith_den1(float n_dot_o, float alpha_sq) {
  return fabsf(n_dot_o) + sqrtf(alpha_sq + (1.0f - alpha_sq) * n_dot_o * n_dot_o);
}

__device__ __forceinline__ float smith_ggx(float n_dot_o, float n_dot_i,
                                           float alpha_g) {
  const float a = alpha_g * alpha_g;
  return 1.0f / (smith_den1(n_dot_i, a) * smith_den1(n_dot_o, a));
}

__device__ __forceinline__ float gtr_2_vndf_pdf(float n_dot_o, float cos_theta_h,
                                                float alpha) {
  // 0.5 / tensor is tensor.reciprocal() * 0.5 in torch
  return gtr_2(cos_theta_h, alpha) *
         ((1.0f / smith_den1(n_dot_o, alpha * alpha)) * PYF(0.5));
}

__device__ __forceinline__ V diffuse_basecolor(const Mat& m) {
  return m.base * (1.0f - m.metallic);
}

__device__ __forceinline__ V specular_basecolor(const Mat& m, float ior) {
  const float r = (ior - 1.0f) / (ior + 1.0f);
  const float d = r * r;
  const float s = d * (1.0f - m.metallic);
  const V bm = m.base * m.metallic;
  return {bm.x + s, bm.y + s, bm.z + s};
}

__device__ __forceinline__ float specular_alpha(const Mat& m) {
  return clamp_min(m.roughness * m.roughness, PYF(0.002));
}

__device__ __forceinline__ float luminance(V c) {
  return PYF(0.2126) * c.x + PYF(0.7152) * c.y + PYF(0.0722) * c.z;
}

__device__ __forceinline__ float cos_half_angle(float c) {
  return (1.0f + c) / sqrtf(clamp_min(c * 2.0f + 2.0f, PYF(1e-12)));
}

// bsdf_gltf._half_vector_v: (w_h, valid, transmit)
__device__ __forceinline__ V half_vector(const Mat& m, V n, V w_o, V w_i,
                                         float i_dot_n, float o_dot_n, float ior,
                                         bool trans, bool& valid, bool& transmit) {
  transmit = i_dot_n * o_dot_n < 0.0f;
  const V w_h_refl = w_i + w_o;
  if (!trans) {
    valid = !transmit;
    return normalize(w_h_refl);
  }
  const V w_h_one = -(w_i * ior) - w_o;
  const V w_h_two = reflect(w_i, n) + w_o;
  const V w_h_trans = m.onesided ? w_h_one : w_h_two;
  const V w_h = normalize(transmit ? w_h_trans : w_h_refl);
  valid = !transmit || ((m.strans > 0.0f) && (dot(w_h, n) > 0.0f));
  return w_h;
}

// bsdf_gltf._component_weights_v
__device__ __forceinline__ void component_weights(const Mat& m, float ior,
                                                  float odh0, float odh1,
                                                  float odh2, float vis1,
                                                  float vis2, bool trans,
                                                  float& w0n, float& w1n,
                                                  float& w2n) {
  const float spec_lum = luminance(specular_basecolor(m, m.ior));
  const float f0 = spec_lum + (1.0f - spec_lum) * gltf_schlick_weight(odh0, 1.0f);
  const float f1 = spec_lum + (1.0f - spec_lum) * gltf_schlick_weight(odh1, 1.0f);
  const float diff_lum = luminance(diffuse_basecolor(m));
  float w0 = (1.0f - f0) * 1.0f * (1.0f - m.metallic) * diff_lum;
  float w2 = 0.0f;
  if (trans) {
    w0 = w0 * (1.0f - m.strans);
    const float f2 = spec_lum + (1.0f - spec_lum) * gltf_schlick_weight(odh2, ior);
    w2 = (1.0f - f2) * vis2 * (1.0f - m.metallic) * m.strans;
  }
  const float w1 = f1 * vis1;
  const float total = w0 + w1 + w2;
  const bool pos = total > 0.0f;
  const float inv = 1.0f / clamp_min(total, PYF(1e-30));
  w0n = pos ? w0 * inv : 1.0f;
  w1n = pos ? w1 * inv : 0.0f;
  w2n = trans ? (pos ? w2 * inv : 0.0f) : w2;
}

// bsdf_gltf.gltf_bsdf_v
__device__ V gltf_bsdf(const Mat& m, V n, V w_o, V w_i, bool trans) {
  const float i_dot_n = dot(n, w_i);
  const float o_dot_n = dot(n, w_o);
  const float ior = o_dot_n < 0.0f ? 1.0f / m.ior : m.ior;
  bool valid, transmit;
  const V w_h = half_vector(m, n, w_o, w_i, i_dot_n, o_dot_n, ior, trans, valid,
                            transmit);
  const float o_dot_h = dot(w_o, w_h);
  const float i_dot_h = dot(w_i, w_h);
  const V diffuse = diffuse_basecolor(m) * PYF(kM1Pi);
  const V f0 = specular_basecolor(m, m.ior);
  const float alpha = specular_alpha(m);
  const float spec_refl =
      gtr_2(dot(n, w_h), alpha) * smith_ggx(o_dot_n, i_dot_n, alpha);
  const float f_weight = gltf_schlick_weight(fabsf(o_dot_h), ior);
  const V F = {f0.x + (1.0f - f0.x) * f_weight, f0.y + (1.0f - f0.y) * f_weight,
               f0.z + (1.0f - f0.z) * f_weight};
  const V omF = {1.0f - F.x, 1.0f - F.y, 1.0f - F.z};
  const bool has_specular = m.ior > 1.0f;
  const V zero = {0.0f, 0.0f, 0.0f};
  if (!trans) {
    const V diffuse_refl = diffuse * omF;
    const V refl_val = has_specular ? diffuse_refl + F * spec_refl : diffuse;
    return valid ? refl_val : zero;
  }
  const V diffuse_refl = diffuse * (1.0f - m.strans) * omF;
  const V spec_side_refl = F * spec_refl;
  const float compression = 2.0f * o_dot_h / (i_dot_h * ior + o_dot_h);
  const float comp2 = m.onesided ? compression * compression : 1.0f;
  const V spec_side_trans =
      (m.tcolor * omF) * (spec_refl * (1.0f - m.metallic) * m.strans * comp2);
  const V refl_val = has_specular ? diffuse_refl + spec_side_refl : diffuse;
  const V trans_val = has_specular ? spec_side_trans : zero;
  const V out = transmit ? trans_val : refl_val;
  return valid ? out : zero;
}

// bsdf_gltf.gltf_wpdf_v
__device__ float gltf_wpdf(const Mat& m, V n, V w_o, V w_i, bool trans) {
  const float i_dot_n = dot(n, w_i);
  const float o_dot_n = dot(n, w_o);
  const float ior = o_dot_n < 0.0f ? 1.0f / m.ior : m.ior;
  const float diffuse_pdf = PYF(kM1Pi) * fabsf(i_dot_n);
  bool valid, transmit;
  const V w_h = half_vector(m, n, w_o, w_i, i_dot_n, o_dot_n, ior, trans, valid,
                            transmit);
  const float o_dot_h = dot(w_o, w_h);
  const float i_dot_h = dot(w_i, w_h);
  const float cos_theta_h = dot(w_h, n);
  const float alpha = specular_alpha(m);
  const float vis_spec =
      2.0f * fabsf(i_dot_n) / smith_den1(i_dot_n, alpha * alpha);
  const float aodh = fabsf(o_dot_h);
  float w0, w1, w2;
  component_weights(m, ior, aodh, aodh, aodh, vis_spec, vis_spec, trans, w0, w1,
                    w2);
  const float specular = gtr_2_vndf_pdf(o_dot_n, cos_theta_h, alpha);
  const float pdf_refl = diffuse_pdf * w0 + specular * w1;
  float pdf = pdf_refl;
  if (trans) {
    const float compression = 2.0f * o_dot_h / (i_dot_h * ior + o_dot_h);
    const float comp2 = m.onesided ? compression * compression : 1.0f;
    const float pdf_trans = specular * comp2 * w2;
    pdf = transmit ? pdf_trans : pdf_refl;
  }
  pdf = m.ior > 1.0f ? pdf : diffuse_pdf;
  return valid ? pdf : 0.0f;
}

// bsdf_gltf.sample_gtr_2_vndf_v
__device__ __forceinline__ V sample_vndf(V w_o_local, float alpha, V up) {
  const V wi_std =
      normalize(V{alpha * w_o_local.x, alpha * w_o_local.y, w_o_local.z}, 0.0f);
  const float z = (1.0f - up.z) * (1.0f + wi_std.z) - wi_std.z;
  const float sin_t = sqrtf(clamp2(1.0f - z * z, 0.0f, 1.0f));
  const V wm_std = {sin_t * up.x + wi_std.x, sin_t * up.y + wi_std.y,
                    z + wi_std.z};
  const V wm = {wm_std.x * alpha, wm_std.y * alpha, clamp_min(wm_std.z, 0.0f)};
  return normalize(wm);
}

// bsdf_gltf.sample_gltf_brdf_v (thin off): weight, w_i and mis_wpdf
__device__ void sample_gltf_brdf(const Mat& m, V n, V w_o, V v_x, V v_y,
                                 float d0, float d1, float r, bool trans,
                                 V& weight, V& w_i, float& mis_wpdf) {
  const V w_o_local = {dot(w_o, v_x), dot(w_o, v_y), dot(w_o, n)};
  const float o_dot_n = w_o_local.z;
  const float ior = o_dot_n < 0.0f ? 1.0f / m.ior : m.ior;
  const V w_o_up = {w_o_local.x, w_o_local.y, fabsf(o_dot_n)};

  const float phi = PYF(2.0 * kPi) * d0;
  const V up = {cosf(phi), sinf(phi), d1};
  // sample_sphere_v
  const float cos_t = up.z * 2.0f - 1.0f;
  const float sin_t = sqrtf(clamp_min(1.0f - cos_t * cos_t, 0.0f));
  V w_i_diffuse = normalize(n + V{sin_t * up.x, sin_t * up.y, cos_t});
  w_i_diffuse = o_dot_n < 0.0f ? -w_i_diffuse : w_i_diffuse;

  const float alpha = specular_alpha(m);
  const V w_h_spec_local = sample_vndf(w_o_up, alpha, up);
  const float odh_diffuse = cos_half_angle(dot(w_o, w_i_diffuse));
  const float odh_spec = dot(w_o_up, w_h_spec_local);
  const float spec_i_dot_n = reflect(-w_o_up, w_h_spec_local).z;
  const float vis_spec =
      spec_i_dot_n > 0.0f
          ? 2.0f * spec_i_dot_n / smith_den1(spec_i_dot_n, alpha * alpha)
          : 0.0f;
  float vis_trans = 0.0f;
  if (trans) {
    const V refr = refract(-w_o_up, w_h_spec_local, 1.0f / ior);
    const float trans_i_dot_n = m.onesided ? -refr.z : spec_i_dot_n;
    vis_trans = (trans_i_dot_n > 0.0f && m.strans > 0.0f)
                    ? 2.0f * trans_i_dot_n / smith_den1(trans_i_dot_n, alpha * alpha)
                    : 0.0f;
  }
  float w0, w1, w2;
  component_weights(m, ior, odh_diffuse, odh_spec, odh_spec, vis_spec,
                    vis_trans, trans, w0, w1, w2);
  const bool has_spec_layer = m.ior > 1.0f;
  w0 = has_spec_layer ? w0 : 1.0f;
  w1 = has_spec_layer ? w1 : 0.0f;
  w2 = has_spec_layer ? w2 : 0.0f;

  const float cdf1 = w0;
  const float cdf2 = w0 + w1;
  const int component = r < cdf1 ? 0 : (r < cdf2 ? 1 : 2);
  const float wsel = component == 0 ? w0 : (component == 1 ? w1 : w2);

  const float sign = o_dot_n < 0.0f ? -1.0f : 1.0f;
  const V whs = {w_h_spec_local.x, w_h_spec_local.y, w_h_spec_local.z * sign};
  const float cos_theta_h_spec = whs.z;
  const V w_h_world = v_x * whs.x + v_y * whs.y + n * whs.z;
  const V w_i_spec = reflect(-w_o, w_h_world);
  const bool is_diff = component == 0;
  const bool is_spec = component == 1;
  if (trans) {
    const V refr_w = refract(-w_o, w_h_world, 1.0f / ior);
    const V w_i_trans = m.onesided ? refr_w : reflect(w_i_spec, n);
    w_i = is_diff ? w_i_diffuse : (is_spec ? w_i_spec : w_i_trans);
  } else {
    w_i = is_diff ? w_i_diffuse : w_i_spec;
  }
  const float i_dot_n = dot(n, w_i);
  bool ok;
  if (trans) {
    ok = component == 2 ? i_dot_n * o_dot_n < 0.0f : i_dot_n * o_dot_n > 0.0f;
  } else {
    ok = i_dot_n * o_dot_n > 0.0f;
  }
  ok = ok && (wsel > 0.0f);

  const V w_h_sel = is_diff ? normalize(w_i + w_o) : w_h_world;
  const float o_dot_h = dot(w_o, w_h_sel);
  const float cos_theta_h = is_diff ? dot(n, w_h_sel) : cos_theta_h_spec;
  const float diffuse_pdf = PYF(kM1Pi) * fabsf(i_dot_n);
  const float specular = gtr_2_vndf_pdf(o_dot_n, cos_theta_h, alpha);
  const float pdf_refl = diffuse_pdf * w0 + specular * w1;
  float pdf = pdf_refl;
  if (trans) {
    const float i_dot_h =
        (component == 2 && m.onesided) ? dot(w_i, w_h_sel) : o_dot_h;
    const float compression = 2.0f * o_dot_h / (i_dot_h * ior + o_dot_h);
    const float comp2 = m.onesided ? compression * compression : 1.0f;
    const float pdf_trans = specular * comp2 * w2;
    pdf = component == 2 ? pdf_trans : pdf_refl;
  }
  pdf = m.ior > 1.0f ? pdf : diffuse_pdf;
  pdf = (ok && pdf > 0.0f) ? pdf : 0.0f;

  const V f = gltf_bsdf(m, n, w_o, w_i, trans);
  const float wpdf = gltf_wpdf(m, n, w_o, w_i, trans);
  const bool good = pdf > 0.0f;
  weight = good ? f * (fabsf(i_dot_n) / clamp_min(pdf, PYF(1e-30)))
                : V{0.0f, 0.0f, 0.0f};
  mis_wpdf = good ? wpdf : 0.0f;
}

// ---------------------------------------------------------------------------
// shade_hit
// ---------------------------------------------------------------------------

template <bool kTextured, bool kSunSky>
__global__ void __launch_bounds__(kBlock) shade_hit_kernel(const HitArgs a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= a.n) return;
  const V ro = {ld<float>(a.p[H_ROX], i), ld<float>(a.p[H_ROY], i),
                ld<float>(a.p[H_ROZ], i)};
  const V rd = {ld<float>(a.p[H_RDX], i), ld<float>(a.p[H_RDY], i),
                ld<float>(a.p[H_RDZ], i)};
  V illum = {ld<float>(a.p[H_ILX], i), ld<float>(a.p[H_ILY], i),
             ld<float>(a.p[H_ILZ], i)};
  const V thr = {ld<float>(a.p[H_THX], i), ld<float>(a.p[H_THY], i),
                 ld<float>(a.p[H_THZ], i)};
  bool active = ld<bool>(a.p[H_ACTIVE], i);
  const float prev_pdf = ld<float>(a.p[H_PREV_PDF], i);
  const int bounce = ld<int>(a.p[H_BOUNCE], i);
  float total_t = ld<float>(a.p[H_TOTAL_T], i);
  const int rays = ld<int>(a.p[H_RAYS], i) + (active ? 1 : 0);
  const float t = ld<float>(a.p[H_T], i);
  const int tri_in = ld<int>(a.p[H_TRI], i);
  const float b1 = ld<float>(a.p[H_U], i), b2 = ld<float>(a.p[H_V], i);

  // ---- miss: sky
  const bool was_miss = tri_in < 0;
  if (active && was_miss) {
    V sky = {0.0f, 0.0f, 0.0f};
    if (kSunSky) sky = sky_illum(a, rd, prev_pdf);
    illum = illum + thr * sky;
  }
  active = active && !was_miss;

  // ---- hit attributes, one gather a column
  const float* attr = static_cast<const float*>(a.p[H_ATTR]);
  const long long R = a.attr_stride;
  const long long tri = tri_in < 0 ? 0 : tri_in;
#define ATTR(k) attr[(k) * R + tri]
  const V e1 = {ATTR(kAE1), ATTR(kAE1 + 1), ATTR(kAE1 + 2)};
  const V e2 = {ATTR(kAE2), ATTR(kAE2 + 1), ATTR(kAE2 + 2)};
  const float b0 = 1.0f - b1 - b2;
  V n_sh = {ATTR(kAN0) * b0 + ATTR(kAN1) * b1 + ATTR(kAN2) * b2,
            ATTR(kAN0 + 1) * b0 + ATTR(kAN1 + 1) * b1 + ATTR(kAN2 + 1) * b2,
            ATTR(kAN0 + 2) * b0 + ATTR(kAN1 + 2) * b1 + ATTR(kAN2 + 2) * b2};
  V gn_raw = cross(e1, e2);
  gn_raw = dot(n_sh, gn_raw) < 0.0f ? -gn_raw : gn_raw;
  const float gn_len = length(gn_raw);
  V gn = gn_raw * (1.0f / clamp_min(gn_len, PYF(1e-20)));
  const float approx_sa = PYF(0.5) * gn_len * fabsf(dot(gn, rd)) /
                          clamp_min(t * t, PYF(1e-20));
  n_sh = normalize(n_sh);

  const float* matt = static_cast<const float*>(a.p[H_MAT]);
  const long long M = a.mat_stride;
  const long long mid = static_cast<long long>(ATTR(kAMid));
#define MATC(k) matt[(k) * M + mid]
  V base = {MATC(kMBase), MATC(kMBase + 1), MATC(kMBase + 2)};
  float roughness = MATC(kMRough);
  const float specular = MATC(kMSpec);
  float metallic = MATC(kMMetal);
  const float ior = MATC(kMIor);
  const float strans = MATC(kMStrans);
  const float emit = MATC(kMEmit);
  const int flags = static_cast<int>(MATC(kMFlags));
  const bool onesided = (flags & kOnesided) != 0;

  const V p = ro + rd * t;
  const V w_o = -rd;
  const bool flip = (dot(w_o, gn) < 0.0f) && !onesided;
  n_sh = flip ? -n_sh : n_sh;
  gn = flip ? -gn : gn;

  total_t = active ? total_t + t : total_t;

  if (kTextured) {
    // shade_textures at aniso_taps 0
    const float uu = ATTR(kAUV0) * b0 + ATTR(kAUV1) * b1 + ATTR(kAUV2) * b2;
    const float vv =
        ATTR(kAUV0 + 1) * b0 + ATTR(kAUV1 + 1) * b1 + ATTR(kAUV2 + 1) * b2;
    const float density = ATTR(kADens);
    V dpdx, dpdy;
    footprint_to_dpdxy(rd, ld<float>(a.p[H_FA], i), ld<float>(a.p[H_FB], i),
                       ld<float>(a.p[H_FC], i), dpdx, dpdy);
    const V dt_un = rd - gn * dot(rd, gn);
    const float cos2 = clamp_min(1.0f - dot(dt_un, dt_un), 0.0f);
    const float elong_s = 1.0f / clamp_min(sqrtf(cos2) + cos2, PYF(1e-6));
    const V ex = dt_un * elong_s;
    const V dpdx_e = dpdx + ex * dot(dpdx, dt_un);
    const V dpdy_e = dpdy + ex * dot(dpdy, dt_un);
    const float footprint_world =
        maximum(length(dpdx_e), length(dpdy_e)) * total_t;
    const int* desc = static_cast<const int*>(a.p[H_DESC]);
    auto mip_of = [&](int tid) {
      const long long mip0 = static_cast<long long>(tid) * kMaxMips;
      const float base_w = static_cast<float>(desc[mip0 * 3 + 1]);
      return log2f(clamp_min(footprint_world * density * base_w, 1.0f));
    };
    const int bc_tid = static_cast<int>(MATC(kMBctex));
    if (bc_tid >= 0) base = sample_atlas(a, bc_tid, uu, vv, mip_of(bc_tid));
    const int sp_tid = static_cast<int>(MATC(kMSptex));
    if (sp_tid >= 0) {
      const V sp = sample_atlas(a, sp_tid, uu, vv, mip_of(sp_tid));
      roughness = sp.y;
      metallic = sp.z;
    }
    const int nm_tid = static_cast<int>(MATC(kMNmtex));
    if (nm_tid >= 0) {
      const V nm = sample_atlas(a, nm_tid, uu, vv, mip_of(nm_tid));
      const V tn = {(nm.x * 2.0f - 1.0f) * a.bump_scale,
                    (nm.y * 2.0f - 1.0f) * a.bump_scale, nm.z * 2.0f - 1.0f};
      V tang = {ATTR(kATan), ATTR(kATan + 1), ATTR(kATan + 2)};
      tang = normalize(tang - n_sh * dot(tang, n_sh));
      const float hand = ATTR(kATan + 3);
      const V bitan = cross(n_sh, tang) * hand;
      const V n_mapped = normalize(tang * tn.x + bitan * tn.y + n_sh * tn.z);
      if (length(tn) > PYF(1e-4)) n_sh = n_mapped;
    }
  }
#undef ATTR
#undef MATC

  // ---- emitter hit MIS
  if (active && emit > 0.0f) {
    const float sun_w = ld<float>(a.p[H_SUN_RAD], 3);
    const float wpdf_light =
        (1.0f - sun_w) * (1.0f / (a.light_n * clamp_min(approx_sa, PYF(1e-12))));
    const float w_emit = mis(prev_pdf, wpdf_light);
    illum = illum + thr * (base * emit) * w_emit;
  }

  st<float>(a.p[O_ILX], i, illum.x);
  st<float>(a.p[O_ILY], i, illum.y);
  st<float>(a.p[O_ILZ], i, illum.z);
  st<float>(a.p[O_TOTAL_T], i, total_t);
  st<float>(a.p[O_PX], i, p.x);
  st<float>(a.p[O_PY], i, p.y);
  st<float>(a.p[O_PZ], i, p.z);
  st<float>(a.p[O_NX], i, n_sh.x);
  st<float>(a.p[O_NY], i, n_sh.y);
  st<float>(a.p[O_NZ], i, n_sh.z);
  st<float>(a.p[O_GX], i, gn.x);
  st<float>(a.p[O_GY], i, gn.y);
  st<float>(a.p[O_GZ], i, gn.z);
  st<float>(a.p[O_WX], i, w_o.x);
  st<float>(a.p[O_WY], i, w_o.y);
  st<float>(a.p[O_WZ], i, w_o.z);
  st<float>(a.p[O_BX], i, base.x);
  st<float>(a.p[O_BY], i, base.y);
  st<float>(a.p[O_BZ], i, base.z);
  st<float>(a.p[O_METALLIC], i, metallic);
  st<float>(a.p[O_SPECULAR], i, specular);
  st<float>(a.p[O_ROUGHNESS], i, roughness);
  st<float>(a.p[O_IOR], i, ior);
  st<float>(a.p[O_STRANS], i, strans);
  st<bool>(a.p[O_ACTIVE], i, active);
  st<int>(a.p[O_BOUNCE], i, active ? bounce + 1 : bounce);
  st<int>(a.p[O_RAYS], i, rays);
  st<bool>(a.p[O_ONESIDED], i, onesided);
  if (a.wavefront) {
    st<float>(a.p[O_PEND_ZERO], i, 0.0f);
    st<float>(a.p[O_PEND_ONE], i, 1.0f);
    st<bool>(a.p[O_PEND_TRACED], i, false);
  }
}

// ---------------------------------------------------------------------------
// shade_scatter
// ---------------------------------------------------------------------------

template <bool kTextured>
__global__ void __launch_bounds__(kBlock) shade_scatter_kernel(const ScatterArgs a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= a.n) return;
  const bool trans = a.transmission != 0;
  const V ro = {ld<float>(a.p[S_ROX], i), ld<float>(a.p[S_ROY], i),
                ld<float>(a.p[S_ROZ], i)};
  const V rd = {ld<float>(a.p[S_RDX], i), ld<float>(a.p[S_RDY], i),
                ld<float>(a.p[S_RDZ], i)};
  V thr = {ld<float>(a.p[S_THX], i), ld<float>(a.p[S_THY], i),
           ld<float>(a.p[S_THZ], i)};
  const bool had_nee = ld<bool>(a.p[S_ACTIVE], i);
  bool active = had_nee;
  float prev_pdf = ld<float>(a.p[S_PREV_PDF], i);
  const int bounce = ld<int>(a.p[S_BOUNCE], i);
  const float total_t = ld<float>(a.p[S_TOTAL_T], i);
  const V p = {ld<float>(a.p[S_PX], i), ld<float>(a.p[S_PY], i),
               ld<float>(a.p[S_PZ], i)};
  const V n_sh = {ld<float>(a.p[S_NX], i), ld<float>(a.p[S_NY], i),
                  ld<float>(a.p[S_NZ], i)};
  const V gn = {ld<float>(a.p[S_GX], i), ld<float>(a.p[S_GY], i),
                ld<float>(a.p[S_GZ], i)};
  const V w_o = {ld<float>(a.p[S_WX], i), ld<float>(a.p[S_WY], i),
                 ld<float>(a.p[S_WZ], i)};
  Mat m;
  m.base = {ld<float>(a.p[S_BX], i), ld<float>(a.p[S_BY], i),
            ld<float>(a.p[S_BZ], i)};
  m.tcolor = {ld<float>(a.p[S_TCX], i), ld<float>(a.p[S_TCY], i),
              ld<float>(a.p[S_TCZ], i)};
  m.metallic = ld<float>(a.p[S_METALLIC], i);
  m.roughness = ld<float>(a.p[S_ROUGHNESS], i);
  m.ior = ld<float>(a.p[S_IOR], i);
  m.strans = ld<float>(a.p[S_STRANS], i);
  m.onesided = ld<bool>(a.p[S_ONESIDED], i);

  // glossy-only debug mode
  if (a.glossy_only) {
    active = active && (m.roughness < PYF(0.1)) && (m.ior != 1.0f);
  }

  // ---- BSDF sample
  V vx, vy;
  ortho_frame(n_sh, vx, vy);
  V weight, w_i;
  float mis_wpdf;
  sample_gltf_brdf(m, n_sh, w_o, vx, vy, ld<float>(a.p[S_DIR0], i),
                   ld<float>(a.p[S_DIR1], i), ld<float>(a.p[S_LOBE0], i), trans,
                   weight, w_i, mis_wpdf);
  const bool valid_dir = dot(w_i, n_sh) * dot(w_i, gn) > 0.0f;
  const bool weight_zero =
      (weight.x == 0.0f) && (weight.y == 0.0f) && (weight.z == 0.0f);
  const bool terminate = (mis_wpdf == 0.0f) || weight_zero || !valid_dir;
  const bool keep = active && !terminate;
  thr = keep ? thr * weight : thr;
  prev_pdf = keep ? mis_wpdf : prev_pdf;
  active = keep;

  if (kTextured) {
    float fa = ld<float>(a.p[S_FA], i), fb = ld<float>(a.p[S_FB], i),
          fc = ld<float>(a.p[S_FC], i);
    const bool do_ref =
        active && (dot(w_i, n_sh) * dot(w_o, n_sh) > PYF(-0.999));
    if (do_ref) reflect_footprint(w_i, rd, fa, fb, fc, fa, fb, fc);
    st<float>(a.p[T_FA], i, fa);
    st<float>(a.p[T_FB], i, fb);
    st<float>(a.p[T_FC], i, fc);
  }

  const V rd_new = active ? w_i : rd;
  const V ro_new = (active || (a.wavefront && had_nee)) ? p : ro;
  const float t_min = (length(ro_new) + total_t) * PYF(kRayEpsilon);

  // ---- Russian roulette
  const float prefix = maximum(thr.x, maximum(thr.y, thr.z));
  const float rr_prob = bounce > 6 ? clamp_max(prefix, PYF(0.95))
                                   : clamp_max(prefix, 1.0f);
  const bool do_rr = active && (bounce >= a.rr_path_depth);
  const bool survive = ld<float>(a.p[S_RR], i) < rr_prob;
  if (do_rr && survive) thr = thr * (1.0f / clamp_min(rr_prob, PYF(1e-9)));
  active = active && (!do_rr || survive);

  st<float>(a.p[T_ROX], i, ro_new.x);
  st<float>(a.p[T_ROY], i, ro_new.y);
  st<float>(a.p[T_ROZ], i, ro_new.z);
  st<float>(a.p[T_RDX], i, rd_new.x);
  st<float>(a.p[T_RDY], i, rd_new.y);
  st<float>(a.p[T_RDZ], i, rd_new.z);
  st<float>(a.p[T_TMIN], i, t_min);
  st<float>(a.p[T_THX], i, thr.x);
  st<float>(a.p[T_THY], i, thr.y);
  st<float>(a.p[T_THZ], i, thr.z);
  st<float>(a.p[T_PREV_PDF], i, prev_pdf);
  st<bool>(a.p[T_ACTIVE], i, active);
}

}  // namespace

// Plain C entries for ctypes. ``ptrs`` is the operand table in the order of
// enum HitPtr / ScatterPtr (``nptrs`` entries; a table the configuration
// does not read, or an output it does not write, may be null). Each launches
// on ``stream`` and returns cudaGetLastError() (0 = launched). The caller
// allocates every output.
extern "C" int rptr_shade_hit(const void* const* ptrs, int nptrs, int n,
                              long long attr_stride, long long mat_stride,
                              int hosek, int textured, int sun_sky,
                              int wavefront, float bump_scale, float light_n,
                              void* stream) {
  if (nptrs != H_NPTR) return cudaErrorInvalidValue;
  if (n <= 0) return 0;
  HitArgs a;
  for (int k = 0; k < H_NPTR; ++k) a.p[k] = ptrs[k];
  a.attr_stride = attr_stride;
  a.mat_stride = mat_stride;
  a.n = n;
  a.hosek = hosek;
  a.wavefront = wavefront;
  a.bump_scale = bump_scale;
  a.light_n = light_n;
  const int grid = (n + kBlock - 1) / kBlock;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (textured) {
    if (sun_sky) shade_hit_kernel<true, true><<<grid, kBlock, 0, s>>>(a);
    else shade_hit_kernel<true, false><<<grid, kBlock, 0, s>>>(a);
  } else {
    if (sun_sky) shade_hit_kernel<false, true><<<grid, kBlock, 0, s>>>(a);
    else shade_hit_kernel<false, false><<<grid, kBlock, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rptr_shade_scatter(const void* const* ptrs, int nptrs, int n,
                                  int textured, int transmission, int wavefront,
                                  int glossy_only, int rr_path_depth,
                                  void* stream) {
  if (nptrs != S_NPTR) return cudaErrorInvalidValue;
  if (n <= 0) return 0;
  ScatterArgs a;
  for (int k = 0; k < S_NPTR; ++k) a.p[k] = ptrs[k];
  a.n = n;
  a.transmission = transmission;
  a.wavefront = wavefront;
  a.glossy_only = glossy_only;
  a.rr_path_depth = rr_path_depth;
  const int grid = (n + kBlock - 1) / kBlock;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (textured) shade_scatter_kernel<true><<<grid, kBlock, 0, s>>>(a);
  else shade_scatter_kernel<false><<<grid, kBlock, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The layout above as doubles, in the order of ops/shade_common.py's LAYOUT;
// returns how many it wrote (at most ``cap``).
extern "C" int rptr_shade_layout(double* out, int cap) {
  const double v[] = {
      kAttrW, kMatW,  kMaxMips, kAE1,    kAE2,   kAN0,    kAN1,
      kAN2,   kAUV0,  kAUV1,    kAUV2,   kATan,  kADens,  kAMid,
      kMBase, kMRough, kMSpec,  kMMetal, kMIor,  kMStrans, kMEmit,
      kMFlags, kMBctex, kMSptex, kMNmtex, kOnesided, kRayEpsilon};
  const int n = static_cast<int>(sizeof(v) / sizeof(v[0]));
  for (int k = 0; k < n && k < cap; ++k) out[k] = v[k];
  return n < cap ? n : cap;
}

extern "C" const char* rptr_shade_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
