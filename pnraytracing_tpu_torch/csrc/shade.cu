// The shade phase of one bounce for Hopper (sm_90a): phase 1 of
// render/integrator.py::_render_rays, one thread a ray; and, further
// down, the tail of the bounce after its walks (accumulate_bounce_kernel)
// and the interaction fill after a closest hit (interaction_kernel).
//
// Replaces no TPU kernel.  In the JAX package XLA fuses this chain; the
// port ran it as plain PyTorch (ops/shade.py::shade_plain), ~1,570
// elementwise kernels a bounce, each reading and writing [R] float
// vectors: 2.78 ms a bounce of 262,144 rays on the H100, 72% of the
// flagship's frame.  Here a lane reads its path state once (pos, nrm,
// v_dir, material id, seed, pixel, the live flag: 65 bytes), gathers its
// material row and one light row / one environment alias row from tables
// that stay in L2, and writes what the later phases read (seed and up to
// 23 floats: 100 bytes).  The bound (chip_smoke.py's shade row) is those
// bytes, and each table's once, at 3.35 TB/s: about 0.014 ms a bounce of
// 262,144 live rays; the arithmetic (three BRDF evaluations, one sample,
// two pdfs: ~1,580 torch results a lane) is about half that at the fp32
// rate.
//
// Values.  Every operation repeats the torch code's, in its order, on
// float32, and the library is built with --fmad=false, so a live lane's
// outputs equal the plain version's bit for bit:
//   * a Python scalar is rounded to float32 first, as torch rounds it
//     (a constant folded in double by Python, such as 2 pi^2 or
//     0.001 - 0.1, is folded here in double too);
//   * torch's CUDA division by a Python scalar multiplies by the float32
//     reciprocal (x / w is x * (1 / w));
//   * clamp_min / clamp keep a NaN, as torch.clamp does (fmaxf drops
//     it), and selects are torch.where's;
//   * sinf, cosf, logf, powf, sqrtf and rsqrtf are what torch's kernels
//     call.
// The RNG words are uint32 (the int64 tensors hold uint32 values), drawn
// in the torch code's order; the frame word is read from device memory
// when the frame is a tensor, so a captured graph draws each replay's
// Sobol pair.
//
// Dead lanes (active false) write zeros and their seed unchanged and
// return: a warp of them costs a few loads and stores.  No later phase
// reads those values (ops/shade.py).
//
// Every form the torch code takes is here, chosen by uniform arguments
// (one instantiation serves them all, so the build stays small): the
// environment draw from the fat alias rows, from the two alias tables
// (a map whose fat rows were dropped, diff/grad.py::apply_params), or by
// CDF inversion (a map without alias tables, ops/envmap.py::
// envmap_in_graph); and compat_pnrt's forms of the draws (the CDF cell,
// its elevation-sine pdf and mirrored bilinear radiance, the reference's
// hemisphere and half-vector forms, the sample's unclamped pdf).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "intersect.cuh"

namespace {

constexpr int kThreads = 256;
constexpr double kPiD = 3.14159265358979323846;
constexpr float kPi = (float)kPiD;
constexpr float kInvPi = (float)0.31830988618379067154;
constexpr float kTwoPi = (float)(2.0 * kPiD);
constexpr float kEps = (float)1e-10;
constexpr int kSobolDims = 8;
constexpr int kIrow = 26;  // columns of the interaction table
constexpr int kMrow = 18;  // columns of ops/shade.py::material_rows
// how the environment draw picks its cell (ops/envmap.py::sample_envmap_v)
constexpr int kEnvFat = 1;    // the fat alias rows: one row a draw
constexpr int kEnvAlias = 2;  // the two alias tables
constexpr int kEnvCdf = 3;    // the CDFs (and every compat draw)

struct F3 {
  float x, y, z;
};

__device__ __forceinline__ F3 add(F3 a, F3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ F3 sub(F3 a, F3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ F3 mul(F3 a, F3 b) {
  return {a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ F3 scale(F3 a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ F3 neg(F3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float dot(F3 a, F3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ F3 cross(F3 a, F3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ F3 select(bool m, F3 a, F3 b) {
  return m ? a : b;
}
// torch.clamp_min / torch.clamp: a NaN stays
__device__ __forceinline__ float cmin(float v, float c) {
  return isnan(v) ? v : fmaxf(v, c);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float safe_sqrt(float x) {
  return sqrtf(cmin(x, (float)1e-12));
}
__device__ __forceinline__ F3 normalize(F3 a) {
  return scale(a, rsqrtf(cmin(dot(a, a), (float)1e-20)));
}
__device__ __forceinline__ float sqr(float x) { return x * x; }
// mix(a, b, t) = a + (b - a) * t with tensors a, b
__device__ __forceinline__ float mix(float a, float b, float t) {
  return a + (b - a) * t;
}
__device__ __forceinline__ F3 vmix(F3 a, F3 b, float t) {
  return add(a, scale(sub(b, a), t));
}
// torch.clamp(j, 0, n - 1) of an index
__device__ __forceinline__ int64_t clamp_index(int64_t j, int n) {
  return j < 0 ? 0 : (j > n - 1 ? n - 1 : j);
}
// ops/shade.py::safe_inv
__device__ __forceinline__ float safe_inv(float x) {
  return fabsf(x) > kEps ? 1.0f / (x == 0.0f ? 1.0f : x) : 0.0f;
}

// ---- a row of the interaction table ---------------------------------------
// (render/integrator.py::pack_interaction_rows: corner positions, corner
// normals, corner uvs, material id, texture id)
struct TriRow {
  F3 p0, p1, p2, n0, n1, n2;
};
__device__ __forceinline__ TriRow load_tri_row(const float* rr) {
  return {{rr[0], rr[1], rr[2]},    {rr[3], rr[4], rr[5]},
          {rr[6], rr[7], rr[8]},    {rr[9], rr[10], rr[11]},
          {rr[12], rr[13], rr[14]}, {rr[15], rr[16], rr[17]}};
}
// a * b0 + b * b1 + c * b2, summed in that order
__device__ __forceinline__ F3 interpolate(F3 a, F3 b, F3 c, float b0,
                                          float b1, float b2) {
  return add(add(scale(a, b0), scale(b, b1)), scale(c, b2));
}
// The surface normal at (b0, b1, b2), before its normalize: the corner
// normals interpolated, or the geometric normal where a corner normal is
// the zero vector (ops/shade.py::any_zero)
__device__ __forceinline__ F3 surface_normal(const TriRow& t, float b0,
                                             float b1, float b2) {
  const F3 geom_n = normalize(cross(sub(t.p1, t.p0), sub(t.p2, t.p0)));
  const F3 n_interp = interpolate(t.n0, t.n1, t.n2, b0, b1, b2);
  auto zero3 = [](F3 a) {
    return (a.x == 0.0f) & (a.y == 0.0f) & (a.z == 0.0f);
  };
  return select(zero3(t.n0) | zero3(t.n1) | zero3(t.n2), geom_n, n_interp);
}

// ---- the RNG (ops/sampling.py) --------------------------------------------
__device__ __forceinline__ uint32_t wang_hash(uint32_t s) {
  s = (s ^ 61u) ^ (s >> 16);
  s = s * 9u;
  s = s ^ (s >> 4);
  s = s * 0x27D4EB2Du;
  return s ^ (s >> 15);
}
__device__ __forceinline__ float u32_to_unit(uint32_t w) {
  return (float)w * (float)(1.0 / 4294967296.0);
}
__device__ __forceinline__ float rand01(uint32_t& s) {
  s = wang_hash(s);
  return u32_to_unit(s);
}

// ---- the material (core/types.py::Materials.gather_components) ----------
struct Mat {
  float subsurface, metallic, specular, specular_tint, roughness,
      anisotropic, sheen, sheen_tint, clearcoat, clearcoat_gloss;
};

// ---- the Disney BRDF (ops/brdf.py) ---------------------------------------
__device__ __forceinline__ float schlick_fresnel(float u) {
  const float m = clamp(1.0f - u, 0.0f, 1.0f);
  const float m2 = m * m;
  return m2 * m2 * m;
}
__device__ __forceinline__ float gtr1(float ndoth, float a) {
  const float a2 = sqr(a);
  const float t = 1.0f + (a2 - 1.0f) * sqr(ndoth);
  const float val =
      (a2 - 1.0f) / (kPi * logf(cmin(a2, kEps)) * cmin(t, kEps));
  return a >= 1.0f ? kInvPi : val;
}
__device__ __forceinline__ float gtr2(float ndoth, float a) {
  const float a2 = sqr(a);
  const float t = 1.0f + (a2 - 1.0f) * sqr(ndoth);
  return a2 / (kPi * cmin(sqr(t), kEps));
}
__device__ __forceinline__ float gtr2_aniso(float ndoth, float hdotx,
                                            float hdoty, float ax, float ay) {
  const float denom =
      kPi * ax * ay * sqr(sqr(hdotx / ax) + sqr(hdoty / ay) + sqr(ndoth));
  return 1.0f / cmin(denom, kEps);
}
__device__ __forceinline__ float smith_g_ggx_quarter(float ndotv) {
  // smith_g_ggx(ndotv, 0.25): a = 0.0625
  const float b = sqr(ndotv);
  return 1.0f / cmin(ndotv + safe_sqrt(0.0625f + b - 0.0625f * b), kEps);
}
__device__ __forceinline__ float smith_g_ggx_aniso(float ndotv, float vdotx,
                                                   float vdoty, float ax,
                                                   float ay) {
  const float denom =
      ndotv + safe_sqrt(sqr(vdotx * ax) + sqr(vdoty * ay) + sqr(ndotv));
  return 1.0f / cmin(denom, kEps);
}
__device__ __forceinline__ float clearcoat_alpha(const Mat& m) {
  // mix(0.1, 0.001, t): (0.001 - 0.1) folded in double
  return m.clearcoat_gloss * (float)(0.001 - 0.1) + (float)0.1;
}
__device__ __forceinline__ float specular_alpha(const Mat& m) {
  return cmin(sqr(m.roughness), (float)0.001);
}

// disney_eval_v: f(V, L) (comp:788-849)
__device__ F3 disney_eval(F3 v, F3 n, F3 l, F3 x, F3 y, const Mat& m,
                          F3 cdlin) {
  const float ndotl = dot(n, l);
  const float ndotv = dot(n, v);
  const bool valid = (ndotl >= 0.0f) & (ndotv >= 0.0f);
  const F3 h = normalize(add(l, v));
  const float ndoth = dot(n, h);
  const float ldoth = dot(l, h);

  const float cdlum =
      (float)0.3 * cdlin.x + (float)0.6 * cdlin.y + (float)0.1 * cdlin.z;
  const float safe_lum = cmin(cdlum, kEps);
  const F3 one = {1.0f, 1.0f, 1.0f};
  const F3 ctint = cdlum > 0.0f
                       ? F3{cdlin.x / safe_lum, cdlin.y / safe_lum,
                            cdlin.z / safe_lum}
                       : one;
  const F3 cspec = scale(vmix(one, ctint, m.specular_tint), m.specular);
  const F3 cspec0 = vmix(scale(cspec, (float)0.08), cdlin, m.metallic);
  const F3 csheen = vmix(one, ctint, m.sheen_tint);

  // diffuse retro-reflection
  const float fd90 = 0.5f + 2.0f * sqr(ldoth) * m.roughness;
  const float fl = schlick_fresnel(ndotl);
  const float fv = schlick_fresnel(ndotv);
  const float fd = (1.0f + (fd90 - 1.0f) * fl) * (1.0f + (fd90 - 1.0f) * fv);

  // Hanrahan-Krueger subsurface approximation
  const float fss90 = sqr(ldoth) * m.roughness;
  const float fss =
      (1.0f + (fss90 - 1.0f) * fl) * (1.0f + (fss90 - 1.0f) * fv);
  const float ss =
      1.25f * (fss * (1.0f / cmin(ndotl + ndotv, kEps) - 0.5f) + 0.5f);

  // anisotropic specular
  const float aspect = safe_sqrt(1.0f - m.anisotropic * (float)0.9);
  const float ax =
      cmin(sqr(m.roughness) / cmin(aspect, kEps), (float)0.001);
  const float ay = cmin(sqr(m.roughness) * aspect, (float)0.001);
  const float ds = gtr2_aniso(ndoth, dot(h, x), dot(h, y), ax, ay);
  const float fh = schlick_fresnel(ldoth);
  const F3 fs = vmix(cspec0, one, fh);
  float gs = smith_g_ggx_aniso(ndotl, dot(l, x), dot(l, y), ax, ay);
  gs = gs * smith_g_ggx_aniso(ndotv, dot(v, x), dot(v, y), ax, ay);

  // clearcoat
  const float dr = gtr1(ndoth, clearcoat_alpha(m));
  const float fr = fh * (float)(1.0 - 0.04) + (float)0.04;
  const float gr = smith_g_ggx_quarter(ndotl) * smith_g_ggx_quarter(ndotv);

  const F3 fsheen = scale(csheen, fh * m.sheen);
  const F3 diffuse =
      add(scale(cdlin, kInvPi * mix(fd, ss, m.subsurface)), fsheen);
  const F3 specular = scale(fs, gs * ds);
  const float cc = 0.25f * gr * fr * dr * m.clearcoat;
  const F3 clearcoat = scale(one, cc);

  const F3 out =
      add(add(scale(diffuse, 1.0f - m.metallic), specular), clearcoat);
  return valid ? out : F3{0.0f, 0.0f, 0.0f};
}

struct Lobes {
  float p_diff, p_spec, p_cc, a_gtr1, a_gtr2;
};

__device__ __forceinline__ Lobes lobes_of(const Mat& m) {
  // lobe_probs (comp:748-755), clearcoat_alpha, specular_alpha
  const float r_diffuse = 1.0f - m.metallic;
  const float r_clearcoat = 0.25f * m.clearcoat;
  const float inv = 1.0f / (r_diffuse + 1.0f + r_clearcoat);
  return {r_diffuse * inv, 1.0f * inv, r_clearcoat * inv, clearcoat_alpha(m),
          specular_alpha(m)};
}

// disney_pdf_v (comp:710-738), clamped >= 0 unless compat
__device__ float disney_pdf(F3 v, F3 n, F3 l, const Lobes& p,
                            bool compat) {
  const F3 h = normalize(add(l, v));
  const float ldoth = dot(l, h);
  const float ndoth = dot(n, h);
  const float ndotl = dot(n, l);
  const float pdf_diffuse = ndotl * kInvPi;
  const float denom = 4.0f * ldoth;
  const float safe = fabsf(denom) < kEps ? kEps : denom;
  const float pdf_spec = gtr2(ndoth, p.a_gtr2) * ndoth / safe;
  const float pdf_cc = gtr1(ndoth, p.a_gtr1) * ndoth / safe;
  const float pdf =
      p.p_diff * pdf_diffuse + p.p_spec * pdf_spec + p.p_cc * pdf_cc;
  return compat ? pdf : cmin(pdf, 0.0f);
}

__device__ __forceinline__ F3 tangent_to_world(F3 t, F3 b, F3 n, F3 v) {
  return add(add(scale(t, v.x), scale(b, v.y)), scale(n, v.z));
}

// _sample_h_local_v, then the frame, then vreflect (comp:687-707); compat
// the reference's sin_theta = 1 - cos^2 and cos_phi = 1 - sin^2
__device__ __forceinline__ F3 reflect_about_h(F3 n, F3 t, F3 b, F3 v,
                                              float r1, float cos_theta_h,
                                              bool compat) {
  const float phi_h = kTwoPi * r1;
  const float sin_phi_h = sinf(phi_h);
  const float sin_theta_h = compat ? cmin(1.0f - sqr(cos_theta_h), 0.0f)
                                   : safe_sqrt(1.0f - sqr(cos_theta_h));
  const float cos_phi_h = compat ? 1.0f - sqr(sin_phi_h) : cosf(phi_h);
  const F3 h = tangent_to_world(
      t, b, n, F3{sin_theta_h * cos_phi_h, sin_theta_h * sin_phi_h,
                  cos_theta_h});
  return sub(scale(h, 2.0f * dot(v, h)), v);
}

// disney_sample_v (comp:742-786): the chosen lobe's direction; *lobe 0 / 1
// / 2 diffuse / specular / clearcoat
__device__ F3 disney_sample(F3 v, F3 n, F3 t, F3 b, const Lobes& p,
                            float r_lobe, float r1, float r2, float u_diff1,
                            float u_diff2, bool compat, int* lobe) {
  const bool take_diff = r_lobe <= p.p_diff;
  const bool take_spec = !take_diff & (r_lobe <= p.p_diff + p.p_spec);
  *lobe = take_diff ? 0 : (take_spec ? 1 : 2);
  if (take_diff) {
    float x, y;
    if (compat) {  // u_diff1 an angle in radians, u_diff2 the radius
      x = u_diff2 * sinf(u_diff1);
      y = u_diff2 * cosf(u_diff1);
    } else {
      const float rr = safe_sqrt(u_diff1);
      const float phi = kTwoPi * u_diff2;
      x = rr * cosf(phi);
      y = rr * sinf(phi);
    }
    return tangent_to_world(t, b, n,
                            F3{x, y, safe_sqrt(1.0f - x * x - y * y)});
  }
  if (take_spec) {
    const float alpha = p.a_gtr2;
    const float cos_theta_h = safe_sqrt(
        (1.0f - r2) / cmin(1.0f + (sqr(alpha) - 1.0f) * r2, kEps));
    return reflect_about_h(n, t, b, v, r1, cos_theta_h, compat);
  }
  const float a2 = sqr(p.a_gtr1);
  const float cos_theta_h =
      safe_sqrt((1.0f - powf(a2, 1.0f - r2)) / cmin(1.0f - a2, kEps));
  return reflect_about_h(n, t, b, v, r1, cos_theta_h, compat);
}

struct Params {
  int r, bounce, width, height, n_lights, env_w, env_h, env_mode, compat;
  uint32_t frame_host;
  const int64_t* frame;  // null: frame_host
  const bool* active;
  const float *px_pos, *py_pos, *pz_pos, *nx, *ny, *nz, *vx, *vy, *vz;
  const int* mat_id;
  const int64_t *seed, *pix_x, *pix_y;
  const float* cdlin;  // null: the material's base color
  const float* mat_rows;
  const float* irows;
  const int* light_tri;
  const float *prefix_area, *total_area;
  const float *alias_x, *alias_y, *alias_fat;
  const float *env_image, *pdf_xy, *cdf_x, *cdf_y;
  const int64_t* sobol_dirs;  // [8, 32]
  int64_t* seed_out;
  float* out;  // [rows, r]
};

// the Sobol value of dimension d at gray-coded index g, as f32(word) *
// f32(1 / 0xFFFFFFFF) (ops/sampling.py::sobol_vec2)
__device__ __forceinline__ float sobol(const int64_t* dirs, int d,
                                       uint32_t g) {
  uint32_t word = 0;
  for (int bit = 0; bit < 32; ++bit) {
    if ((g >> bit) & 1u) word ^= (uint32_t)dirs[d * 32 + bit];
  }
  return (float)word * (float)(1.0 / 4294967295.0);
}

// the first index of sorted[0, n) not below `want` (torch.searchsorted,
// side="left")
__device__ __forceinline__ int lower_bound(const float* sorted, int n,
                                           float want) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(sorted[mid] >= want)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// one alias draw over n cells: keep cell j = clamp(floor(u n)) when the
// fraction is below row[0], else take row[1]
__device__ __forceinline__ int64_t alias_pick(const float* rows, int n,
                                              float u) {
  const int64_t j = clamp_index((int64_t)(u * (float)n), n);
  const float frac = u * (float)n - (float)j;
  const float* row = rows + j * 2;
  return frac < row[0] ? j : (int64_t)row[1];
}

// torch.remainder of an index
__device__ __forceinline__ int64_t wrap_index(int64_t j, int n) {
  const int64_t m = j % n;
  return m < 0 ? m + n : m;
}

// ops/envmap.py::bilinear_lookup of the [h, w, 3] image at (u, v): u
// wraps, v clamps
__device__ F3 bilinear(const float* image, int w, int h, float u, float v) {
  const float fx = u * (float)w - 0.5f;
  const float fy = v * (float)h - 0.5f;
  const float x0 = floorf(fx);
  const float y0 = floorf(fy);
  const float tx = fx - x0;
  const float ty = fy - y0;
  const int64_t x0i = wrap_index((int64_t)x0, w);
  const int64_t x1i = wrap_index(x0i + 1, w);
  const int64_t y0i = clamp_index((int64_t)y0, h);
  const int64_t y1i = clamp_index(y0i + 1, h);
  float out[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float c00 = image[(y0i * w + x0i) * 3 + k];
    const float c10 = image[(y0i * w + x1i) * 3 + k];
    const float c01 = image[(y1i * w + x0i) * 3 + k];
    const float c11 = image[(y1i * w + x1i) * 3 + k];
    const float top = c00 * (1.0f - tx) + c10 * tx;
    const float bot = c01 * (1.0f - tx) + c11 * tx;
    out[k] = top * (1.0f - ty) + bot * ty;
  }
  return F3{out[0], out[1], out[2]};
}

// ops/envmap.py::sample_envmap_v: the direction, its radiance and pdf of
// one environment draw (u1, u2), by p.env_mode, or compat's form
__device__ void sample_env(const Params& p, float u1, float u2, F3* dir,
                           F3* radiance, float* pdf) {
  const int w = p.env_w, h = p.env_h;
  int64_t x, y;
  float p2d = 0.0f;
  F3 rad = {0.0f, 0.0f, 0.0f};
  if (p.env_mode == kEnvFat && !p.compat) {
    x = alias_pick(p.alias_x, w, u1);
    const int64_t j2 = clamp_index((int64_t)(u2 * (float)h), h);
    const float frac2 = u2 * (float)h - (float)j2;
    const float* fat = p.alias_fat + (x * h + j2) * 10;
    const bool take = frac2 < fat[0];
    y = take ? j2 : (int64_t)fat[1];
    rad = take ? F3{fat[2], fat[3], fat[4]} : F3{fat[5], fat[6], fat[7]};
    p2d = take ? fat[8] : fat[9];
  } else {
    if (p.env_mode == kEnvAlias && !p.compat) {
      x = alias_pick(p.alias_x, w, u1);
      y = alias_pick(p.alias_y + x * h * 2, h, u2);
    } else {  // searchsorted over the marginal, bisection of the row
      x = clamp_index(lower_bound(p.cdf_x, w, u1), w);
      const float* row = p.cdf_y + x * h;
      int lo = 0, hi = h;
      while (lo < hi) {  // ops/envmap.py::_bisect_rows: row[mid] < u
        const int mid = (lo + hi) >> 1;
        if (row[mid] < u2) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      y = clamp_index(lo, h);
    }
    p2d = p.pdf_xy[x * h + y];
  }
  if (p.compat) {  // the elevation sine, the mirrored row (comp:563-575)
    const float u = (float)x * (1.0f / (float)w);
    const float v = (float)y * (1.0f / (float)h);
    const float phi = kTwoPi * (u - 0.5f);
    const float theta = kPi * (0.5f - v);
    const float cos_t = cosf(theta);
    const float sin_t = sinf(theta);
    *dir = F3{cos_t * cosf(phi), sin_t, cos_t * sinf(phi)};
    // c / t is t.reciprocal() * c in torch
    const float sin_c = cmin(sin_t, (float)1e-10);
    *pdf = p2d * ((1.0f / ((float)(2.0 * kPiD * kPiD) * sin_c)) *
                  (float)(((int64_t)w * h) / 2));
    *radiance = bilinear(p.env_image, w, h, u, 1.0f - v);
    return;
  }
  if (p.env_mode != kEnvFat) {
    const float* px = p.env_image + (y * w + x) * 3;
    rad = F3{px[0], px[1], px[2]};
  }
  // (x + 0.5) / w: torch multiplies by the float32 reciprocal
  const float u = ((float)x + 0.5f) * (1.0f / (float)w);
  const float v = ((float)y + 0.5f) * (1.0f / (float)h);
  const float phi = kTwoPi * (u - 0.5f);
  const float theta = kPi * (0.5f - v);
  const float cos_t = cosf(theta);
  *dir = F3{cos_t * cosf(phi), sinf(theta), cos_t * sinf(phi)};
  *pdf = p2d * (float)((int64_t)w * h) /
         ((float)(2.0 * kPiD * kPiD) * cmin(cos_t, (float)1e-6));
  *radiance = rad;
}

template <bool kLights, bool kEnv, bool kSobol, bool kBalanced>
__global__ void __launch_bounds__(kThreads)
    shade_bounce_kernel(const Params p) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.r) return;
  const int r = p.r;
  constexpr int kRows =
      7 + 7 * kLights + 7 * kEnv + kBalanced * (kLights + kEnv);
  float* o = p.out + i;
  const uint32_t seed_in = (uint32_t)p.seed[i];
  if (!p.active[i]) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) o[k * r] = 0.0f;
    p.seed_out[i] = (int64_t)seed_in;
    return;
  }
  const F3 pos = {p.px_pos[i], p.py_pos[i], p.pz_pos[i]};
  const F3 nrm = {p.nx[i], p.ny[i], p.nz[i]};
  const F3 v = {p.vx[i], p.vy[i], p.vz[i]};
  const float* mr = p.mat_rows + (int64_t)p.mat_id[i] * kMrow;
  const Mat m = {mr[0], mr[1], mr[2], mr[3], mr[4],
                 mr[5], mr[6], mr[7], mr[8], mr[9]};
  F3 cdlin = {mr[12], mr[13], mr[14]};
  if (p.cdlin != nullptr) {
    const float* cd = p.cdlin + 3 * (int64_t)i;
    cdlin = F3{cd[0], cd[1], cd[2]};
  }

  // the tangent frame (build_tangent_space_v)
  const bool near_z = fabsf(nrm.z) > (float)0.9999995;
  const F3 t_general = normalize(F3{nrm.y * 1.0f - nrm.z * 0.0f,
                                    nrm.z * 0.0f - nrm.x * 1.0f,
                                    nrm.x * 0.0f - nrm.y * 0.0f});
  const F3 t_tan = near_z ? F3{1.0f, 0.0f, 0.0f} : t_general;
  const F3 b_tan = cross(nrm, t_tan);

  uint32_t seed = seed_in;
  const Lobes lobes = lobes_of(m);
  int row = 7;

  // phase 1a: NEE area-light draws (comp:878-909)
  const float u_light = rand01(seed);
  F3 lnorm = {0.0f, 0.0f, 0.0f};
  if (kLights) {
    // pick_light: searchsorted(prefix, u * total, side="left"), clamped
    const float total = *p.total_area;
    const int lo = lower_bound(p.prefix_area, p.n_lights, u_light * total);
    const int slot = min(max(lo, 0), p.n_lights - 1);
    const int64_t tri = p.light_tri[slot];
    const float u1 = rand01(seed);
    const float u2 = rand01(seed);
    // sample_light_point (comp:604-624)
    const float su = safe_sqrt(u1);
    const float b0 = 1.0f - su;
    const float b1 = u2 * su;
    const float* rr = p.irows + tri * kIrow;
    const TriRow corners = load_tri_row(rr);
    const float b2 = 1.0f - b0 - b1;
    const F3 lp = interpolate(corners.p0, corners.p1, corners.p2, b0, b1, b2);
    const F3 ln = normalize(surface_normal(corners, b0, b1, b2));

    const F3 sdir = sub(lp, pos);
    const float dis2 = dot(sdir, sdir);
    lnorm = normalize(sdir);
    const float cos_l = fabsf(dot(ln, neg(lnorm)));
    const float raw_pdf = dis2 / cmin(cos_l * total, (float)1e-12);
    const int lmat = (int)rr[24];
    const float* lr = p.mat_rows + (int64_t)lmat * kMrow;
    const F3 li = {lr[15], lr[16], lr[17]};
    const F3 light_f = disney_eval(v, nrm, lnorm, t_tan, b_tan, m, cdlin);
    const float nl = fabsf(dot(nrm, lnorm));
    const F3 ldp = scale(mul(light_f, li), nl * safe_inv(raw_pdf));
    o[row++ * r] = sdir.x;
    o[row++ * r] = sdir.y;
    o[row++ * r] = sdir.z;
    o[row++ * r] = raw_pdf;
    o[row++ * r] = ldp.x;
    o[row++ * r] = ldp.y;
    o[row++ * r] = ldp.z;
  }

  // phase 1b: NEE environment draws (comp:911-926)
  F3 en_l = {0.0f, 0.0f, 0.0f};
  if (kEnv) {
    const float u1 = rand01(seed);
    const float u2 = rand01(seed);
    F3 en_li;
    float env_pdf;
    sample_env(p, u1, u2, &en_l, &en_li, &env_pdf);
    const F3 env_f = disney_eval(v, nrm, en_l, t_tan, b_tan, m, cdlin);
    const F3 lep =
        scale(mul(env_f, en_li), dot(en_l, nrm) * safe_inv(env_pdf));
    o[row++ * r] = en_l.x;
    o[row++ * r] = en_l.y;
    o[row++ * r] = en_l.z;
    o[row++ * r] = env_pdf;
    o[row++ * r] = lep.x;
    o[row++ * r] = lep.y;
    o[row++ * r] = lep.z;
  }

  // phase 1c: BRDF sample (comp:928-934)
  float r1, r2;
  if (kSobol) {
    const uint32_t frame =
        p.frame != nullptr ? (uint32_t)*p.frame : p.frame_host;
    const uint32_t idx = frame + 1u;
    const uint32_t g = idx ^ (idx >> 1);
    const int d0 = (2 * p.bounce) % kSobolDims;
    const float su = sobol(p.sobol_dirs, d0, g);
    const float sv = sobol(p.sobol_dirs, d0 + 1, g);
    // cranley_patterson_rotation_c, salt (2 * bounce) // SOBOL_DIMS
    const uint32_t salt = (uint32_t)((2 * p.bounce) / kSobolDims);
    uint32_t s = (uint32_t)p.pix_x[i] * ((uint32_t)p.width * 1973u) +
                 (uint32_t)p.pix_y[i] * ((uint32_t)p.height * 9277u) +
                 59u * 26699u + salt * 0x9E3779B9u;
    s |= 1u;
    const float cu = rand01(s);
    const float cv = rand01(s);
    const float a = su + cu;
    const float b = sv + cv;
    r1 = a > 1.0f ? a - 1.0f : a;
    r2 = b > 1.0f ? b - 1.0f : b;
  } else {
    r1 = rand01(seed);
    r2 = rand01(seed);
  }
  const float r_lobe = rand01(seed);
  // diffuse-lobe draws leave the stream only when that lobe is taken
  const uint32_t s1 = wang_hash(seed);
  const uint32_t s2 = wang_hash(s1);
  int lobe;
  const F3 l_out = disney_sample(v, nrm, t_tan, b_tan, lobes, r_lobe, r1, r2,
                                 u32_to_unit(s1), u32_to_unit(s2),
                                 p.compat != 0, &lobe);
  const float d_pdf = disney_pdf(v, nrm, l_out, lobes, p.compat != 0);
  if (lobe == 0) seed = s2;

  const F3 d_f = disney_eval(v, nrm, l_out, t_tan, b_tan, m, cdlin);
  const F3 weight = scale(d_f, fabsf(dot(nrm, l_out)) * safe_inv(d_pdf));
  o[0] = l_out.x;
  o[r] = l_out.y;
  o[2 * r] = l_out.z;
  o[3 * r] = weight.x;
  o[4 * r] = weight.y;
  o[5 * r] = weight.z;
  o[6 * r] = d_pdf;
  if (kBalanced) {
    if (kLights) {
      o[row++ * r] = cmin(disney_pdf(v, nrm, lnorm, lobes, false), 0.0f);
    }
    if (kEnv) {
      o[row++ * r] = cmin(disney_pdf(v, nrm, en_l, lobes, false), 0.0f);
    }
  }
  p.seed_out[i] = (int64_t)seed;
}

using Kernel = void (*)(const Params);

// by flags: 1 area lights, 2 environment map, 4 Sobol sampler, 8 balanced
// MIS
#define PNRT_SHADE(f)                                                     \
  shade_bounce_kernel<((f) & 1) != 0, ((f) & 2) != 0, ((f) & 4) != 0,     \
                      ((f) & 8) != 0>
const Kernel kKernels[16] = {
    PNRT_SHADE(0),  PNRT_SHADE(1),  PNRT_SHADE(2),  PNRT_SHADE(3),
    PNRT_SHADE(4),  PNRT_SHADE(5),  PNRT_SHADE(6),  PNRT_SHADE(7),
    PNRT_SHADE(8),  PNRT_SHADE(9),  PNRT_SHADE(10), PNRT_SHADE(11),
    PNRT_SHADE(12), PNRT_SHADE(13), PNRT_SHADE(14), PNRT_SHADE(15)};
#undef PNRT_SHADE

// ---- the tail of a bounce ------------------------------------------------
//
// After the bounce's walks: the NEE combine of the shadow phase and the
// accumulate phase of render/integrator.py::_render_rays, one thread a
// ray (ops/shade.py::accumulate_bounce).  Its plain version,
// accumulate_plain, is ~215 torch kernels a bounce (169 + 46 nodes of a
// captured frame), ~0.58 ms a bounce of 262,144 rays on the H100.  A lane
// reads its path state, the bounce's sample and NEE terms and its
// continuation hit, and writes the state it rolls: about 230 bytes a live
// lane, 130 a dead one, so ~60 MB a bounce of 262,144 live rays, 0.018 ms
// at 3.35 TB/s (chip_smoke.py's accumulate row).  Only an escaped ray
// reads a 48-byte quad row of the environment (and one pdf under
// balanced MIS), only a hit its 12-byte emission.  The additions to
// lo keep the torch code's order (NEE, escaped, emissive) and its
// operations, so a lane's outputs equal the plain version's bit for bit,
// a dead lane's too: its lo gains the three zero terms (through the
// max_radiance clamp), its other state passes through, v_dir = -l_out,
// and under Russian roulette its seed advances.

// torch.maximum / torch.minimum: a NaN in either operand wins
__device__ __forceinline__ float tmax(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

// core/math.py::fast_atan, fast_atan2, fast_asin
__device__ __forceinline__ float fast_atan(float t) {
  const float s = t * t;
  float q = (float)-0.0117212;
  q = q * s + (float)0.05265332;
  q = q * s + (float)-0.11643287;
  q = q * s + (float)0.19354346;
  q = q * s + (float)-0.33262347;
  q = q * s + (float)0.99997726;
  return t * q;
}
__device__ __forceinline__ float fast_atan2(float y, float x) {
  const float ax = fabsf(x);
  const float ay = fabsf(y);
  const float big = tmax(ax, ay);
  float r = fast_atan(tmin(ax, ay) / cmin(big, (float)1e-30));
  r = ay > ax ? (float)(0.5 * kPiD) - r : r;
  r = x < 0.0f ? kPi - r : r;
  return y < 0.0f ? -r : r;
}
__device__ __forceinline__ float fast_asin(float v) {
  v = clamp(v, -1.0f, 1.0f);
  return fast_atan2(v, sqrtf(cmin(1.0f - v * v, 0.0f)));
}

// core/vec.py::spherical_uv_v
__device__ __forceinline__ void spherical_uv(F3 d, float* u, float* v) {
  *u = fast_atan2(d.z, d.x) * (float)(0.5 * 0.31830988618379067154) + 0.5f;
  const float w = fast_asin(d.y) * kInvPi + 0.5f;
  *v = 1.0f - w;
}

// ops/envmap.py::bilinear_lookup_quads_v: one [12] row of the [h, w, 12]
// quad table at (u, v): u wraps, v clamps
__device__ F3 quad_lookup(const float* quad12, int w, int h, float u,
                          float v) {
  const float fx = u * (float)w - 0.5f;
  const float fy = v * (float)h - 0.5f;
  const float x0 = floorf(fx);
  const float y0 = floorf(fy);
  const int64_t x0i = wrap_index((int64_t)x0, w);
  const int64_t y0i = clamp_index((int64_t)y0, h);
  const float* q = quad12 + (y0i * w + x0i) * 12;
  const float tx = fx - x0;
  const float ty = fy - y0;
  float out[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float top = q[k] * (1.0f - tx) + q[3 + k] * tx;
    const float bot = q[6 + k] * (1.0f - tx) + q[9 + k] * tx;
    out[k] = top * (1.0f - ty) + bot * ty;
  }
  return F3{out[0], out[1], out[2]};
}

// The inputs, in the order of ops/shade.py::accumulate_bounce's pointer
// array (a V3 is its three components).  Null where the flags read none.
struct TailIn {
  const bool* active;
  const float *c[3], *lo[3], *l_out[3], *weight[3], *d_pdf;
  const int64_t* seed;
  // the NEE terms (flag 1: the light's, flag 2: the environment's, flag
  // 4: the BRDF pdfs of both directions)
  const bool* occluded;
  const float *raw_pdf, *l_direct_pre[3];
  const bool *facing, *e_occ;
  const float *env_pdf_raw, *l_env_pre[3];
  const float *p_b_light, *p_b_env;
  // the continuation hit and its interaction
  const int* tri;
  const float *t, *pos2[3], *nrm2[3];
  const int* mat_id2;
  const float *u2, *v2;
  const int* tex_id2;
  // the path's surface (flag 8: its uv and texture id; lod: its length)
  const float *pos[3], *nrm[3];
  const int* mat_id;
  const float *u, *v;
  const int* tex_id;
  const float* path_t;
  // tables: material rows (emission in columns 15-17), the lights' total
  // area, the constant environment, the map's quad rows or image and pdf
  const float *mat_rows, *total_area, *env_const;
  const float *quad12, *env_image, *pdf_xy;
};
constexpr int kTailInputs = sizeof(TailIn) / sizeof(void*);

struct TailParams {
  int r, env_w, env_h, quad, lod, rr, clamp_on;
  float max_radiance, env_scale;
  TailIn in;
  float* out;        // [15 (+ 2 with flag 8) (+ 1 with lod), r]
  int* ids;          // [1 (+ 1 with flag 8), r]: mat_id, tex_id
  bool* active_out;  // [r]
  int64_t* seed_out;  // [r] with rr, else null
};

__device__ __forceinline__ F3 load3(const float* const* a, int i) {
  return F3{a[0][i], a[1][i], a[2][i]};
}

// render/integrator.py's clamp_contrib: torch.clamp_max keeps a NaN
__device__ __forceinline__ F3 clamp_contrib(const TailParams& p, F3 x) {
  if (!p.clamp_on) return x;
  auto c1 = [&](float a) { return isnan(a) ? a : fminf(a, p.max_radiance); };
  return F3{c1(x.x), c1(x.y), c1(x.z)};
}

// ops/envmap.py::envmap_pdf_v at the direction's (u, v)
__device__ __forceinline__ float env_pdf_at(const TailParams& p, float u,
                                            float v) {
  const int w = p.env_w, h = p.env_h;
  const int64_t x = clamp_index((int64_t)(u * (float)w), w);
  const int64_t y = clamp_index((int64_t)(v * (float)h), h);
  const float theta = kPi * (0.5f - v);
  const float cos_theta = cmin(cosf(theta), (float)1e-6);
  return p.in.pdf_xy[x * h + y] * (float)((int64_t)w * h) /
         ((float)(2.0 * kPiD * kPiD) * cos_theta);
}

template <bool kLights, bool kEnv, bool kBalanced, bool kTex>
__global__ void __launch_bounds__(kThreads)
    accumulate_bounce_kernel(const TailParams p) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.r) return;
  const TailIn& a = p.in;
  const int r = p.r;
  const F3 zero = {0.0f, 0.0f, 0.0f};
  const bool active = a.active[i];
  F3 c = load3(a.c, i);
  F3 lo = load3(a.lo, i);
  const F3 l_out = load3(a.l_out, i);
  F3 pos = load3(a.pos, i);
  F3 nrm = load3(a.nrm, i);
  int mat_id = a.mat_id[i];
  float u = 0.0f, v = 0.0f, path_t = 0.0f;
  int tex_id = 0;
  if (kTex) {
    u = a.u[i];
    v = a.v[i];
    tex_id = a.tex_id[i];
    if (p.lod) path_t = a.path_t[i];
  }

  // the three terms lo gains, zero on a lane they do not reach
  F3 nee_term = zero, escaped = zero, emitted = zero;
  F3 c_next = c;
  bool hit_now = false;
  if (active) {
    const float d_pdf = a.d_pdf[i];
    // the NEE combine (the masks applied to the pre-folded terms)
    float light_pdf = 0.0f, env_pdf = 0.0f;
    F3 l_direct = zero, l_env = zero;
    if (kLights) {
      const bool lit = !a.occluded[i];
      light_pdf = lit ? a.raw_pdf[i] : 0.0f;
      l_direct = lit ? load3(a.l_direct_pre, i) : zero;
    }
    if (kEnv) {
      env_pdf = a.env_pdf_raw[i];
      l_env = a.facing[i] && !a.e_occ[i] ? load3(a.l_env_pre, i) : zero;
    }
    F3 nee;
    if (!kBalanced) {  // the GLSL one-sample combine (comp:937-938)
      const float pdf_sum = env_pdf + light_pdf + d_pdf;
      const float inv_sum =
          pdf_sum > kEps ? 1.0f / (pdf_sum == 0.0f ? 1.0f : pdf_sum) : 0.0f;
      nee = scale(add(scale(l_env, env_pdf), scale(l_direct, light_pdf)),
                  inv_sum);
    } else {
      nee = zero;
      if (kLights) {
        const float w_l =
            light_pdf / cmin(light_pdf + a.p_b_light[i], kEps);
        nee = add(nee, scale(l_direct, w_l));
      }
      if (kEnv) {
        const float w_e = env_pdf / cmin(env_pdf + a.p_b_env[i], kEps);
        nee = add(nee, scale(l_env, w_e));
      }
    }
    nee_term = mul(c, nee);

    const F3 weight = load3(a.weight, i);
    if (a.tri[i] < 0) {  // escaped: the environment's radiance
      float w_b_env = 1.0f;
      F3 radiance;
      if (kEnv) {
        float su, sv;
        spherical_uv(l_out, &su, &sv);
        if (kBalanced) {
          const float p_e_out = env_pdf_at(p, su, sv);
          w_b_env = d_pdf / cmin(d_pdf + p_e_out, kEps);
        }
        radiance = p.quad ? quad_lookup(a.quad12, p.env_w, p.env_h, su, sv)
                          : bilinear(a.env_image, p.env_w, p.env_h, su, sv);
      } else {  // env_const * env_scale, times ones
        radiance = scale(F3{a.env_const[0] * p.env_scale,
                            a.env_const[1] * p.env_scale,
                            a.env_const[2] * p.env_scale},
                         1.0f);
      }
      escaped = scale(mul(mul(c, radiance), weight), w_b_env);
    } else {  // a hit: its emission, the throughput and the state roll
      hit_now = true;
      const int mat2 = a.mat_id2[i];
      const float* mr = a.mat_rows + (int64_t)mat2 * kMrow;
      const F3 emissive = {mr[15], mr[16], mr[17]};
      const F3 nrm2 = load3(a.nrm2, i);
      float w_b_emis = 1.0f;
      if (kBalanced && kLights) {
        // the solid-angle pdf of the area-light strategy at this hit
        const float t2 = a.t[i];
        const float cos_h = fabsf(dot(nrm2, l_out));
        const float p_l_hit =
            (t2 * t2) / cmin(cos_h * *a.total_area, (float)1e-12);
        const bool is_emissive = (emissive.x != 0.0f) |
                                 (emissive.y != 0.0f) | (emissive.z != 0.0f);
        w_b_emis = is_emissive ? d_pdf / cmin(d_pdf + p_l_hit, kEps) : 1.0f;
      }
      emitted = scale(mul(mul(c, emissive), weight), w_b_emis);
      c_next = mul(c, weight);
      pos = load3(a.pos2, i);
      nrm = nrm2;
      mat_id = mat2;
      if (kTex) {
        u = a.u2[i];
        v = a.v2[i];
        tex_id = a.tex_id2[i];
        if (p.lod) path_t = path_t + a.t[i];
      }
    }
  }
  lo = add(lo, clamp_contrib(p, nee_term));
  lo = add(lo, clamp_contrib(p, escaped));
  lo = add(lo, clamp_contrib(p, emitted));
  c = c_next;
  bool alive = hit_now;

  // Russian roulette (not in the reference): every lane draws
  if (p.rr) {
    uint32_t seed = (uint32_t)a.seed[i];
    const float u_rr = rand01(seed);
    const float p_survive = clamp(tmax(tmax(c.x, c.y), c.z), (float)0.05,
                                  (float)0.95);
    const bool survive = u_rr < p_survive;
    if (alive && survive) {
      c = F3{c.x / p_survive, c.y / p_survive, c.z / p_survive};
    }
    alive = alive && survive;
    p.seed_out[i] = (int64_t)seed;
  }

  float* o = p.out + i;
  const F3 rows[5] = {lo, c, neg(l_out), pos, nrm};
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    o[(3 * k) * r] = rows[k].x;
    o[(3 * k + 1) * r] = rows[k].y;
    o[(3 * k + 2) * r] = rows[k].z;
  }
  p.ids[i] = mat_id;
  if (kTex) {
    o[15 * r] = u;
    o[16 * r] = v;
    if (p.lod) o[17 * r] = path_t;
    p.ids[r + i] = tex_id;
  }
  p.active_out[i] = alive;
}

// by flags: 1 area lights, 2 environment map, 4 balanced MIS, 8 textures
#define PNRT_TAIL(f)                                                       \
  accumulate_bounce_kernel<((f) & 1) != 0, ((f) & 2) != 0, ((f) & 4) != 0, \
                           ((f) & 8) != 0>
using TailKernel = void (*)(const TailParams);
const TailKernel kTailKernels[16] = {
    PNRT_TAIL(0),  PNRT_TAIL(1),  PNRT_TAIL(2),  PNRT_TAIL(3),
    PNRT_TAIL(4),  PNRT_TAIL(5),  PNRT_TAIL(6),  PNRT_TAIL(7),
    PNRT_TAIL(8),  PNRT_TAIL(9),  PNRT_TAIL(10), PNRT_TAIL(11),
    PNRT_TAIL(12), PNRT_TAIL(13), PNRT_TAIL(14), PNRT_TAIL(15)};
#undef PNRT_TAIL

// ---- the interaction fill after a closest hit -----------------------------
//
// render/integrator.py::make_interaction, one thread a ray
// (ops/shade.py::fill_interaction): every route but `attr` runs its
// closest walk and then this fill.  Its plain version is ~260 torch
// kernels a call, 0.86 ms over 262,144 rays on the H100 (config5's
// bounce 0), 144 calls a 2048x2048 depth-8 frame.  A lane reads its hit
// (triangle and barycentrics, 12 B), its ray (24 B) and its triangle's
// 104-byte row of the interaction table, and writes its position,
// normal, uv and two ids (40 B): 180 B a lane, ~47 MB a call of 262,144
// rays, 0.014 ms at 3.35 TB/s (chip_smoke.py's interaction row; missed
// lanes share row 0, so a call needs less).  Every lane is computed, a
// missed one too (tri -1 reads row 0), as the plain version computes it;
// the watertight test is intersect.cuh's, the one the walks run, so the
// barycentrics and every output equal the plain version's bit for bit.
struct FillParams {
  int r;
  float t_max;  // the re-test's segment: core/math.py::FLOAT_MAX
  const int* tri;
  const float *b1, *b2;
  const float *ox, *oy, *oz, *dx, *dy, *dz;
  const float* irows;
  float* out;  // [8, r]: pos, nrm, u, v
  int* ids;    // [2, r]: material id, texture id
};

__global__ void __launch_bounds__(kThreads)
    interaction_kernel(const FillParams p) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.r) return;
  const int r = p.r;
  const float* rr = p.irows + (int64_t)max(p.tri[i], 0) * kIrow;
  const TriRow row = load_tri_row(rr);
  const F3 d = {p.dx[i], p.dy[i], p.dz[i]};
  // the barycentrics re-derived by intersecting the hit triangle again
  const pnrt::Ray ray =
      pnrt::make_ray<false>(p.ox[i], p.oy[i], p.oz[i], d.x, d.y, d.z);
  float t, rb1, rb2;
  const bool ok = pnrt::hit_corners(
      ray, row.p0.x, row.p0.y, row.p0.z, row.p1.x, row.p1.y, row.p1.z,
      row.p2.x, row.p2.y, row.p2.z, p.t_max, t, rb1, rb2);
  const float b1 = ok ? rb1 : p.b1[i];
  const float b2 = ok ? rb2 : p.b2[i];
  const float b0 = 1.0f - b1 - b2;
  const F3 pos = interpolate(row.p0, row.p1, row.p2, b0, b1, b2);
  const F3 n = surface_normal(row, b0, b1, b2);
  // backface flip toward the incoming ray (comp:345-348)
  const F3 nrm = normalize(select(dot(n, d) > 0.0f, neg(n), n));
  const float u = rr[18] * b0 + rr[20] * b1 + rr[22] * b2;
  const float v = rr[19] * b0 + rr[21] * b1 + rr[23] * b2;
  float* o = p.out + i;
  o[0] = pos.x;
  o[r] = pos.y;
  o[2 * r] = pos.z;
  o[3 * r] = nrm.x;
  o[4 * r] = nrm.y;
  o[5 * r] = nrm.z;
  o[6 * r] = u;
  o[7 * r] = v;
  p.ids[i] = (int)rr[24];
  p.ids[r + i] = (int)rr[25];
}

// what == 0 registers, 1 blocks an SM, 2 threads a block, 3 local bytes of
// kernel k; a negative value is minus the CUDA error
int kernel_attribute(const void* k, int what) {
  if (what == 2) return kThreads;
  if (what == 1) {
    int blocks = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads, 0);
    return err == cudaSuccess ? blocks : -(int)err;
  }
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, k);
  if (err != cudaSuccess) return -(int)err;
  return what == 0 ? attr.numRegs : (int)attr.localSizeBytes;
}

}  // namespace

extern "C" {

// One launch over r rays.  flags as kKernels; env_mode kEnvFat /
// kEnvAlias / kEnvCdf with flag 2 (compat draws by the CDFs whatever it
// is), compat 1 for compat_pnrt's forms; frame may be null (then
// frame_host is the frame word); cdlin may be null ([r, 3] otherwise);
// the light tables are null without flag 1, the environment tables
// without flag 2 and those env_mode and compat do not read, sobol_dirs
// without flag 4.  out: [rows, r] f32 in the order of
// ops/shade.py::shade_bounce.  Returns cudaGetLastError() after the
// launch.
int pnrt_shade(int flags, int r, int bounce, int width, int height,
               int n_lights, int env_w, int env_h, int env_mode, int compat,
               unsigned int frame_host,
               const int64_t* frame, const bool* active, const float* pos_x,
               const float* pos_y, const float* pos_z, const float* nx,
               const float* ny, const float* nz, const float* vx,
               const float* vy, const float* vz, const int* mat_id,
               const int64_t* seed, const int64_t* pix_x, const int64_t* pix_y,
               const float* cdlin, const float* mat_rows, const float* irows,
               const int* light_tri, const float* prefix_area,
               const float* total_area, const float* alias_x,
               const float* alias_y, const float* alias_fat,
               const float* env_image, const float* pdf_xy,
               const float* cdf_x, const float* cdf_y,
               const int64_t* sobol_dirs,
               int64_t* seed_out, float* out, void* stream) {
  if (r <= 0) return 0;
  if (flags < 0 || flags > 15) return (int)cudaErrorInvalidValue;
  if ((flags & 2) && (env_mode < kEnvFat || env_mode > kEnvCdf)) {
    return (int)cudaErrorInvalidValue;
  }
  const Params p = {r,         bounce,     width,       height,
                    n_lights,  env_w,      env_h,       env_mode,
                    compat,    frame_host, frame,       active,
                    pos_x,     pos_y,      pos_z,       nx,
                    ny,        nz,         vx,          vy,
                    vz,        mat_id,     seed,        pix_x,
                    pix_y,     cdlin,      mat_rows,    irows,
                    light_tri, prefix_area, total_area, alias_x,
                    alias_y,   alias_fat,  env_image,   pdf_xy,
                    cdf_x,     cdf_y,      sobol_dirs,  seed_out,
                    out};
  const int blocks = (r + kThreads - 1) / kThreads;
  kKernels[flags]<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p);
  return (int)cudaGetLastError();
}

// what == 0 the registers a thread, 1 the blocks an SM holds at once, 2
// the threads a block, 3 the local (spilled) bytes a thread, of the
// instantiation for flags.  A negative value is minus the CUDA error.
int pnrt_shade_kernel_info(int flags, int what) {
  if (flags < 0 || flags > 15) return -(int)cudaErrorInvalidValue;
  return kernel_attribute((const void*)kKernels[flags], what);
}

// The tail of a bounce over r rays.  flags as kTailKernels; quad 1 to
// read the map's quad rows, 0 its image; lod 1 to roll the path length
// (with flag 8); rr 1 for a bounce at or past rr_start; clamp_on 1 for a
// max_radiance; in: kTailInputs pointers in TailIn's order (host
// memory, read here).  out, ids, active_out as TailParams; seed_out only
// with rr.  Returns cudaGetLastError() after the launch.
int pnrt_accumulate(int flags, int r, int env_w, int env_h, int quad,
                    int lod, int rr, int clamp_on, float max_radiance,
                    float env_scale, const void* const* in, float* out,
                    int* ids, bool* active_out, int64_t* seed_out,
                    void* stream) {
  if (r <= 0) return 0;
  if (flags < 0 || flags > 15) return (int)cudaErrorInvalidValue;
  TailParams p;
  p.r = r;
  p.env_w = env_w;
  p.env_h = env_h;
  p.quad = quad;
  p.lod = lod;
  p.rr = rr;
  p.clamp_on = clamp_on;
  p.max_radiance = max_radiance;
  p.env_scale = env_scale;
  static_assert(sizeof(TailIn) == kTailInputs * sizeof(void*),
                "TailIn holds pointers only");
  memcpy(&p.in, in, sizeof(TailIn));
  p.out = out;
  p.ids = ids;
  p.active_out = active_out;
  p.seed_out = seed_out;
  const int blocks = (r + kThreads - 1) / kThreads;
  kTailKernels[flags]<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// The number of pointers pnrt_accumulate reads from `in`.
int pnrt_accumulate_inputs() { return kTailInputs; }

// As pnrt_shade_kernel_info, of the tail's instantiation for flags.
int pnrt_accumulate_kernel_info(int flags, int what) {
  if (flags < 0 || flags > 15) return -(int)cudaErrorInvalidValue;
  return kernel_attribute((const void*)kTailKernels[flags], what);
}

// The interaction fill over r rays: tri int32, b1, b2 and the ray's
// components float32 [r]; irows the [T, 26] interaction table; out [8, r]
// f32 and ids [2, r] int32 as FillParams.  Returns cudaGetLastError()
// after the launch.
int pnrt_interaction(int r, float t_max, const int* tri, const float* b1,
                     const float* b2, const float* ox, const float* oy,
                     const float* oz, const float* dx, const float* dy,
                     const float* dz, const float* irows, float* out,
                     int* ids, void* stream) {
  if (r <= 0) return 0;
  const FillParams p = {r,  t_max, tri, b1, b2,    ox,  oy,
                        oz, dx,    dy,  dz, irows, out, ids};
  const int blocks = (r + kThreads - 1) / kThreads;
  interaction_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// As pnrt_shade_kernel_info, of the fill kernel (one instantiation: flags
// must be 0).
int pnrt_interaction_kernel_info(int flags, int what) {
  if (flags != 0) return -(int)cudaErrorInvalidValue;
  return kernel_attribute((const void*)interaction_kernel, what);
}

}  // extern "C"
