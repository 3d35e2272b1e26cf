// The path tracer's bounce shading, one thread per lane: everything the
// wavefront loop (minipath_tpu_torch/render/wavefront.py::_pt_trace) does
// between a closest-hit trace and the next compaction or trace, except the
// shadow trace itself. It replaces no TPU kernel: the JAX package leaves
// this stretch to XLA, which fuses it on the TPU. On the card PyTorch runs
// it as a few hundred elementwise kernels a bounce, each reading and writing
// whole (N, 3) arrays over every lane; this kernel reads a lane's hit, its
// path state, its uniforms and the small material and light rows (which stay
// in L2) once, and writes its next state and its NEE segment once.
//
// What bounds it on an H100: bytes. A lane reads up to ~120 B and writes
// ~65 B (~118 B on a NEE bounce); the arithmetic (a few transcendentals and
// two normalizations a lane) is a fraction of the time those bytes take at
// 3.35 TB/s. So the design reads nothing a lane does not need: a lane past
// the live count, or inactive, only carries its state over; a lane that
// misses reads no uniform and no table row.
//
// Per lane, in the plain path's order (wavefront.py::_shade_plain):
//   1. the environment on a miss;
//   2. BSDF sampling as scatter_full does it (Lambertian, metal mirror and
//      Phong lobe, dielectric Schlick choice), with its pdf;
//   3. the strata (stratify.py: hashed jitter, or Owen-scrambled Sobol)
//      computed here from the lane's pixel slot;
//   4. the emitter hit, MIS-weighted against NEE (hit_light_pdf);
//   5. on a NEE bounce, the light sample (sample_lights), the candidate mask,
//      the shadow roulette, the segment and the MIS-weighted contribution,
//      which the caller adds where the shadow trace finds no blocker;
//   6. path roulette and the next state.
// Every floating-point step is the plain path's, in its order, rounded as
// PyTorch's CUDA kernels round it: a division by a Python scalar is a
// multiply by the float32 reciprocal, `c / x` is `(1 / x) * c`, a dot
// product over the last axis sums (x, z) first and y after (the order of
// torch.sum's reduction over three elements), and torch.linalg.cross
// contracts its first product into a fused multiply-subtract. The library is
// built with -fmad=false, so nothing else is fused.

#include <cstdint>
#include <cuda_runtime.h>

#include "strata.cuh"

#define MP_SHADE_BLOCK 256

namespace {

enum { LAMBERTIAN = 0, METAL = 1, DIELECTRIC = 2, EMISSIVE = 3 };

// float32 constants as PyTorch forms them from the plain path's Python
// doubles: 2 * pi, 1 / float(2 * pi) and 1 / float(pi).
constexpr float TWO_PI = 0x1.921fb6p+2f;
constexpr float INV_2PI = 0x1.45f306p-3f;
constexpr float INV_PI = 0x1.45f306p-2f;
constexpr float EPS = 1e-3f;  // wavefront.py::_EPS
constexpr float GLOSSY_MIN_FUZZ = 1e-3f;

struct ShadeArgs {
  int64_t n;
  const int* live;  // one i32 in device memory, or null: every lane
  // The trace's hits.
  const float* t;
  const int* tri;
  const float* normal;
  int64_t s_normal;  // row stride in elements; the last axis is contiguous
  const int* material;
  // The path state: pointer and row stride in elements.
  const float* origin;
  int64_t s_origin;
  const float* direction;
  int64_t s_direction;
  const float* inv_direction;
  int64_t s_inv_direction;
  const float* throughput;
  int64_t s_throughput;
  const float* radiance;
  int64_t s_radiance;
  const int* pixel;
  int64_t s_pixel;
  const bool* active;
  int64_t s_active;
  const float* prev_pdf;  // null without NEE
  int64_t s_prev_pdf;
  // Uniforms drawn by the caller, null where not drawn; (N,) or (N, 2).
  const float* u_z;
  const float* u_phi;
  const float* u_lobe;
  const float* u_choice;
  const float* u_light;
  const float* u_tri;
  const float* u_rr;
  const float* u_path;
  // The material table.
  const int* kind;
  const float* albedo;
  const float* emission;
  const float* param;
  // The environment's two colours, (3,) each.
  const float* horizon;
  const float* zenith;
  // The light table (null without NEE).
  const float* l_v0;
  const float* l_e1;
  const float* l_e2;
  const float* l_normal;
  const float* l_area;
  const float* l_emission;
  const float* l_pmf;
  const float* l_cdf;
  const int* l_tri_light;
  int64_t n_lights;
  // Strata.
  int strat_mode;
  int spp;  // |spp|
  int gx;
  int gy;
  float inv_spp;
  float inv_gx;
  float inv_gy;
  int strat_offset;
  int strat_seed;
  int block_start;
  int lanes;         // P0: lanes of a packet
  int block_pixels;  // pixels of a packet's block
  unsigned salt_bsdf;
  unsigned salt_nee;
  // Flags.
  int nee;        // the state carries prev_pdf; emitter hits take MIS weight
  int nee_here;   // sample a light at this bounce
  int shadow_rr;  // shadow-ray roulette
  int roulette;   // path roulette at this bounce
  float rr_floor;
  // The next state, contiguous.
  float* o_origin;
  float* o_direction;
  float* o_inv_direction;
  float* o_throughput;
  float* o_radiance;
  bool* o_active;
  float* o_prev_pdf;  // null without NEE
  // The NEE query (nee_here only), contiguous.
  bool* cand;
  float* sh_origin;
  float* segment;
  float* wi;
  int* light;
  float* contrib;
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* p, int64_t i, int64_t stride) {
  const float* q = p + i * stride;
  return V3{q[0], q[1], q[2]};
}

__device__ __forceinline__ void store3(float* p, int64_t i, V3 v) {
  float* q = p + 3 * i;
  q[0] = v.x;
  q[1] = v.y;
  q[2] = v.z;
}

__device__ __forceinline__ V3 add(V3 a, V3 b) { return V3{a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return V3{a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return V3{a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 scale(V3 a, float s) { return V3{a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 neg(V3 a) { return V3{-a.x, -a.y, -a.z}; }

// torch.clamp: NaN passes through.
__device__ __forceinline__ float clamp_min(float v, float lo) { return isnan(v) ? v : fmaxf(v, lo); }
__device__ __forceinline__ float clamp_max(float v, float hi) { return isnan(v) ? v : fminf(v, hi); }
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
// amax over the three channels: NaN wins.
__device__ __forceinline__ float max2(float a, float b) { return (isnan(a) || a > b) ? a : b; }
__device__ __forceinline__ float amax(V3 a) { return max2(max2(a.x, a.y), a.z); }

// torch.sum(a * b, dim=-1): the products, then (x + z) + y.
__device__ __forceinline__ float dot(V3 a, V3 b) {
  const float px = a.x * b.x, py = a.y * b.y, pz = a.z * b.z;
  return (px + pz) + py;
}

// wavefront.py::_normalize.
__device__ __forceinline__ V3 normalize(V3 v) { return scale(v, rsqrtf(clamp_min(dot(v, v), 1e-30f))); }

// torch.linalg.cross on the card: fma(a1, b2, -(a2 * b1)) per component.
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return V3{__fmaf_rn(a.y, b.z, -(a.z * b.y)), __fmaf_rn(a.z, b.x, -(a.x * b.z)),
            __fmaf_rn(a.x, b.y, -(a.y * b.x))};
}

__device__ __forceinline__ V3 reflect(V3 d, V3 n) { return sub(d, scale(n, dot(d, n) * 2.0f)); }

// wavefront.py::phong_exponent: 2 / max(fuzz, 1e-3)^2 - 2, the division as
// torch's reciprocal times 2.
__device__ __forceinline__ float phong_exponent(float fuzz) {
  const float c = clamp_min(fuzz, GLOSSY_MIN_FUZZ);
  return (1.0f / (c * c)) * 2.0f - 2.0f;
}

// wavefront.py::phong_pdf.
__device__ __forceinline__ float phong_pdf(float n_exp, float cos_alpha) {
  const float c = clamp(cos_alpha, 0.0f, 1.0f);
  const float powed = expf(n_exp * logf(clamp_min(c, 1e-12f)));
  return c > 0.0f ? ((n_exp + 1.0f) * INV_2PI) * powed : 0.0f;
}

// ---- the strata (csrc/strata.cuh) -----------------------------------------

struct Strata {
  int s;    // the lane's sample index
  int pid;  // its pixel id, the render's seed mixed in
};

__device__ __forceinline__ float strat1d(const ShadeArgs& a, Strata st, float u, unsigned salt) {
  return stratify1d(a.strat_mode, a.spp, a.inv_spp, st.s, st.pid, u, salt);
}

__device__ __forceinline__ void strat2d(const ShadeArgs& a, Strata st, float& u1, float& u2, unsigned salt) {
  stratify2d(a.strat_mode, a.spp, a.gx, a.inv_gx, a.inv_gy, st.s, st.pid, u1, u2, salt);
}

// ---- the kernel ------------------------------------------------------------

__device__ __forceinline__ void carry_over(const ShadeArgs& a, int64_t i, V3 o, V3 d, V3 inv, V3 thr, V3 rad) {
  store3(a.o_origin, i, o);
  store3(a.o_direction, i, d);
  store3(a.o_inv_direction, i, inv);
  store3(a.o_throughput, i, thr);
  store3(a.o_radiance, i, rad);
  a.o_active[i] = false;
  if (a.o_prev_pdf) a.o_prev_pdf[i] = 0.0f;
  if (a.nee_here) {
    // Not a candidate; zeros keep the shadow batch's sort keys defined.
    const V3 zero{0.0f, 0.0f, 0.0f};
    a.cand[i] = false;
    store3(a.sh_origin, i, zero);
    store3(a.segment, i, zero);
    store3(a.wi, i, zero);
    a.light[i] = 0;
    store3(a.contrib, i, zero);
  }
}

__global__ void __launch_bounds__(MP_SHADE_BLOCK) shade_kernel(const ShadeArgs a) {
  const int64_t i = (int64_t)blockIdx.x * MP_SHADE_BLOCK + threadIdx.x;
  if (i >= a.n) return;
  const int64_t live = a.live ? (int64_t)*a.live : a.n;
  const V3 o = load3(a.origin, i, a.s_origin);
  const V3 d = load3(a.direction, i, a.s_direction);
  const V3 invd = load3(a.inv_direction, i, a.s_inv_direction);
  const V3 thr = load3(a.throughput, i, a.s_throughput);
  V3 rad = load3(a.radiance, i, a.s_radiance);
  // Lanes past the live count are dead (compaction sank them to a suffix):
  // they only carry their state over.
  if (i >= live || !a.active[i * a.s_active]) {
    carry_over(a, i, o, d, invd, thr, rad);
    return;
  }
  const int tri = a.tri[i];
  if (tri < 0) {
    // 1. The environment on a miss; the path ends.
    const float tt = (d.y + 1.0f) * 0.5f;
    const float w0 = 1.0f - tt;
    const V3 env{a.horizon[0] * w0 + a.zenith[0] * tt, a.horizon[1] * w0 + a.zenith[1] * tt,
                 a.horizon[2] * w0 + a.zenith[2] * tt};
    rad = add(rad, mul(thr, env));
    carry_over(a, i, o, d, invd, thr, rad);
    return;
  }

  const float t = a.t[i];
  const V3 n = load3(a.normal, i, a.s_normal);
  const int m = a.material[i];
  const int kind = a.kind[m];
  const float param = a.param[m];
  const V3 albedo = load3(a.albedo, m, 3);

  Strata st{0, 0};
  if (a.strat_mode != STRAT_NONE) {
    const int pix = a.pixel[i * a.s_pixel];
    const int within = pix % a.lanes;
    st.s = a.strat_offset + within / a.block_pixels;
    st.pid = ((pix / a.lanes + a.block_start) * a.block_pixels + within % a.block_pixels) ^ a.strat_seed;
  }

  // 2. BSDF sampling (scatter_full).
  const float d_dot_n = dot(d, n);
  const bool front = d_dot_n < 0.0f;
  const V3 nf = front ? n : neg(n);
  const bool is_lam = kind == LAMBERTIAN, is_met = kind == METAL, is_die = kind == DIELECTRIC,
             is_emi = kind == EMISSIVE;
  const bool sobol = a.strat_mode == STRAT_SOBOL;

  // The mirror direction: the metal's axis, the dielectric's reflection,
  // and the glossy NEE lobe's axis.
  const V3 refl = normalize(reflect(d, nf));
  const bool glossy = param >= GLOSSY_MIN_FUZZ;
  const float n_exp = phong_exponent(param);

  V3 new_dir;
  float pdf = 0.0f;
  bool terminate = is_emi;
  if (is_lam) {
    float u_z = sobol ? 0.0f : a.u_z[i], u_phi = sobol ? 0.0f : a.u_phi[i];
    if (a.strat_mode != STRAT_NONE) strat2d(a, st, u_z, u_phi, a.salt_bsdf + 0);
    const float z = u_z * 2.0f + -1.0f;
    const float phi = TWO_PI * u_phi;
    const float r = sqrtf(clamp_min(1.0f - z * z, 0.0f));
    V3 lam = normalize(add(nf, V3{r * cosf(phi), r * sinf(phi), z}));
    if (dot(lam, nf) <= 1e-6f) lam = nf;
    new_dir = lam;
    pdf = clamp_min(dot(new_dir, nf), 0.0f) * INV_PI;
  } else if (is_met) {
    float u0 = sobol ? 0.0f : a.u_lobe[2 * i], u1 = sobol ? 0.0f : a.u_lobe[2 * i + 1];
    if (a.strat_mode != STRAT_NONE) strat2d(a, st, u0, u1, a.salt_bsdf + 1);
    V3 met = refl;
    if (glossy) {
      const float cos_a = expf(logf(clamp_min(u0, 1e-12f)) / (n_exp + 1.0f));
      const float sin_a = sqrtf(clamp_min(1.0f - cos_a * cos_a, 0.0f));
      const float phi = TWO_PI * u1;
      // wavefront.py::_orthobasis about the mirror direction.
      const float flip = fabsf(refl.x) > 0.9f ? 1.0f : 0.0f;
      const V3 t1 = normalize(cross(V3{1.0f - flip, flip, 0.0f}, refl));
      const V3 t2 = cross(refl, t1);
      met = add(add(scale(refl, cos_a), scale(t1, sin_a * cosf(phi))), scale(t2, sin_a * sinf(phi)));
      pdf = phong_pdf(n_exp, cos_a);
    }
    new_dir = met;
    terminate = dot(met, nf) <= 0.0f;
  } else if (is_die) {
    float choice = sobol ? 0.0f : a.u_choice[i];
    if (a.strat_mode != STRAT_NONE) choice = strat1d(a, st, choice, a.salt_bsdf + 2);
    const float ior = clamp_min(param, 1.0001f);
    const float eta = front ? 1.0f / ior : ior;
    const float cos_theta = clamp_max(-dot(d, nf), 1.0f);
    const float sin_theta = sqrtf(clamp_min(1.0f - cos_theta * cos_theta, 0.0f));
    const bool cannot_refract = eta * sin_theta > 1.0f;
    const float q = (1.0f - eta) / (1.0f + eta);
    const float r0 = q * q;
    const float schlick = r0 + (1.0f - r0) * powf(1.0f - cos_theta, 5.0f);
    if (cannot_refract || schlick > choice) {
      new_dir = refl;
    } else {
      const V3 perp = scale(add(d, scale(nf, cos_theta)), eta);
      const V3 para = scale(nf, -sqrtf(fabsf(1.0f - dot(perp, perp))));
      new_dir = normalize(add(perp, para));
    }
  } else {
    new_dir = nf;
  }
  const V3 atten = is_die ? V3{1.0f, 1.0f, 1.0f} : (is_emi ? V3{0.0f, 0.0f, 0.0f} : albedo);
  V3 emitted = is_emi ? load3(a.emission, m, 3) : V3{0.0f, 0.0f, 0.0f};

  // 4. The emitter hit, weighted by the power heuristic against NEE from the
  // previous vertex (hit_light_pdf).
  if (a.nee) {
    const float pp = a.prev_pdf[i * a.s_prev_pdf];
    if (pp > 0.0f) {
      const int li = a.l_tri_light[tri];
      float pdf_l = 0.0f;
      if (li >= 0) {
        const float cos_y = fabsf(dot(d, load3(a.l_normal, li, 3)));
        pdf_l = a.l_pmf[li] / a.l_area[li] * (t * t) / clamp_min(cos_y, 1e-8f);
      }
      const float pp2 = pp * pp;
      emitted = scale(emitted, pp2 / (pp2 + pdf_l * pdf_l));
    }
  }
  rad = add(rad, mul(thr, emitted));
  V3 thr2 = mul(thr, atten);
  const V3 point = add(o, scale(d, t));

  // 5. NEE: one light sample and one occlusion segment at diffuse and glossy
  // vertices.
  if (a.nee_here) {
    const bool lobe = is_met && glossy;
    bool cand = is_lam || lobe;
    const V3 sh_o = add(point, scale(nf, EPS));
    float u = sobol ? 0.0f : a.u_light[i];
    if (a.strat_mode != STRAT_NONE) u = strat1d(a, st, u, a.salt_nee + 0);
    // torch.searchsorted (left) over the inclusive CDF, clamped.
    int64_t lo = 0, hi = a.n_lights;
    while (lo < hi) {
      const int64_t mid = lo + ((hi - lo) >> 1);
      if (!(a.l_cdf[mid] >= u)) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int64_t li = lo < a.n_lights - 1 ? lo : a.n_lights - 1;
    float r0 = sobol ? 0.0f : a.u_tri[2 * i], r1 = sobol ? 0.0f : a.u_tri[2 * i + 1];
    if (a.strat_mode != STRAT_NONE) strat2d(a, st, r0, r1, a.salt_nee + 1);
    const float s = sqrtf(r0);
    const float bu = 1.0f - s, bv = r1 * s;
    const V3 y = add(add(load3(a.l_v0, li, 3), scale(load3(a.l_e1, li, 3), bu)), scale(load3(a.l_e2, li, 3), bv));
    const V3 seg = sub(y, sh_o);
    const float dist2 = dot(seg, seg);
    const float dist = sqrtf(clamp_min(dist2, 1e-12f));
    const V3 wi = V3{seg.x / dist, seg.y / dist, seg.z / dist};
    const float cos_y = fabsf(dot(wi, load3(a.l_normal, li, 3)));
    const float pdf_nee = a.l_pmf[li] / a.l_area[li] * dist2 / clamp_min(cos_y, 1e-8f);
    const float cos_x = dot(wi, nf);
    cand = cand && cos_x > 0.0f && cos_y > 1e-6f && pdf_nee > 0.0f;
    float rr_w = 1.0f;
    if (a.shadow_rr) {
      const float q_rr = clamp(amax(thr2), 0.05f, 1.0f);
      cand = cand && a.u_rr[i] < q_rr;
      rr_w = 1.0f / q_rr;
    }
    // The BSDF value times cos and its pdf toward the light, per lobe.
    float pdf_b_l;
    V3 fcos;
    if (lobe) {
      const float lobe_pdf_l = phong_pdf(n_exp, dot(wi, refl));
      pdf_b_l = lobe_pdf_l;
      fcos = scale(albedo, lobe_pdf_l);
    } else {
      pdf_b_l = cos_x * INV_PI;
      fcos = scale(scale(albedo, INV_PI), cos_x);
    }
    const float p2 = pdf_nee * pdf_nee;
    const float w_nee = p2 / (p2 + pdf_b_l * pdf_b_l);
    const V3 contrib = scale(mul(mul(thr, fcos), load3(a.l_emission, li, 3)), w_nee / pdf_nee * rr_w);
    a.cand[i] = cand;
    store3(a.sh_origin, i, sh_o);
    store3(a.segment, i, sub(sub(y, scale(wi, EPS)), sh_o));
    store3(a.wi, i, wi);
    a.light[i] = (int)li;
    store3(a.contrib, i, contrib);
  }

  // 6. Path roulette and the next state. Dielectric transmission crosses
  // the surface: the offset follows the new direction's side.
  const V3 offset_dir = dot(new_dir, nf) >= 0.0f ? nf : neg(nf);
  const V3 new_origin = add(point, scale(offset_dir, EPS));
  const V3 inv{new_dir.x == 0.0f ? INFINITY : 1.0f / new_dir.x, new_dir.y == 0.0f ? INFINITY : 1.0f / new_dir.y,
               new_dir.z == 0.0f ? INFINITY : 1.0f / new_dir.z};
  bool active = !terminate;
  if (a.roulette) {
    const float p = clamp(amax(thr2), a.rr_floor, 1.0f);
    const bool survived = a.u_path[i] < p;
    if (active && survived) thr2 = V3{thr2.x / p, thr2.y / p, thr2.z / p};
    active = active && survived;
  }
  store3(a.o_origin, i, new_origin);
  store3(a.o_direction, i, new_dir);
  store3(a.o_inv_direction, i, inv);
  store3(a.o_throughput, i, thr2);
  store3(a.o_radiance, i, rad);
  a.o_active[i] = active;
  if (a.o_prev_pdf) a.o_prev_pdf[i] = a.nee_here ? pdf : 0.0f;
}

}  // namespace

extern "C" {

const char* mp_shade_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int mp_shade_args_size() { return (int)sizeof(ShadeArgs); }

// One bounce's shading over `args->n` lanes on `stream`. Returns the
// launch's cudaError_t (0 on success). The arguments are read on the host,
// at the launch.
int mp_shade_bounce(const void* args, void* stream) {
  const ShadeArgs& a = *(const ShadeArgs*)args;
  if (a.n == 0) return 0;
  if (a.strat_mode != STRAT_NONE && (a.spp < 1 || a.lanes < 1 || a.block_pixels < 1 || a.gx < 1))
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (a.n + MP_SHADE_BLOCK - 1) / MP_SHADE_BLOCK;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  shade_kernel<<<(unsigned)blocks, MP_SHADE_BLOCK, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
