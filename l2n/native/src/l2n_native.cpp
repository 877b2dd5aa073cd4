// l2n native tier: multithreaded CPU reference renderer + RNG cores.
//
// The framework's analog of the reference's host-side renderer
// (l2n-renderer/src/main.cpp:206-599 `CPUSpherePathtracing`): a fully
// independent scalar implementation of the same pipeline, used as a test
// oracle against the JAX/Pallas paths. Parallelism mirrors the reference:
// one std::thread per hardware thread pulling tiles from an atomic queue
// (main.cpp:516-592).
//
// RNG: counter-based threefry-2x32 keyed on (pixel, sample, pair) — the
// same addressing as l2n.rng.threefry — plus a canonical TinyMT32
// implementation (from the TinyMT spec; the reference embeds the same
// algorithm at src/tinymt32.{hpp,cpp}) for the stateful parity mode.
//
// Build: see l2n/native/__init__.py (g++ -O3 -shared -fPIC).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Threefry-2x32 (Salmon et al.), identical constants to rng/threefry.py.
// ---------------------------------------------------------------------------

constexpr int kRot[8] = {13, 15, 26, 6, 17, 29, 16, 24};

inline uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

inline void threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1,
                         uint32_t* o0, uint32_t* o1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
  for (int block = 0; block < 5; ++block) {
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl(x1, kRot[(block % 2) * 4 + r]);
      x1 ^= x0;
    }
    const int inj = block + 1;
    x0 += ks[inj % 3];
    x1 += ks[(inj + 1) % 3] + static_cast<uint32_t>(inj);
  }
  *o0 = x0;
  *o1 = x1;
}

// uint32 -> float strictly in (0, 1): the reference's 0x3f800001 exponent
// trick (rand_tinymt32.cs.glsl:96-112).
inline float uniform_oo(uint32_t bits) {
  uint32_t u = (bits >> 9) | 0x3F800001u;
  float f;
  std::memcpy(&f, &u, 4);
  return f - 1.0f;
}

// ---------------------------------------------------------------------------
// TinyMT32 (127-bit state; Saito & Matsumoto algorithm).
// ---------------------------------------------------------------------------

struct TinyMT {
  uint32_t s[4];
  uint32_t mat1, mat2, tmat;
};

inline void tinymt_next(TinyMT* r) {
  uint32_t y = r->s[3];
  uint32_t x = (r->s[0] & 0x7FFFFFFFu) ^ r->s[1] ^ r->s[2];
  x ^= x << 1;
  y ^= (y >> 1) ^ x;
  r->s[0] = r->s[1];
  r->s[1] = r->s[2];
  r->s[2] = x ^ (y << 10);
  r->s[3] = y;
  uint32_t m = 0u - (y & 1u);
  r->s[1] ^= m & r->mat1;
  r->s[2] ^= m & r->mat2;
}

inline uint32_t tinymt_temper(const TinyMT* r) {
  uint32_t t0 = r->s[3];
  uint32_t t1 = r->s[0] + (r->s[2] >> 8);
  t0 ^= t1;
  return t0 ^ ((0u - (t1 & 1u)) & r->tmat);
}

inline float tinymt_float_oo(TinyMT* r) {
  tinymt_next(r);
  uint32_t t0 = r->s[3];
  uint32_t t1 = r->s[0] + (r->s[2] >> 8);
  t0 ^= t1;
  uint32_t u = ((t0 ^ ((0u - (t1 & 1u)) & r->tmat)) >> 9) | 0x3F800001u;
  float f;
  std::memcpy(&f, &u, 4);
  return f - 1.0f;
}

void tinymt_init(TinyMT* r, uint32_t seed) {
  r->s[0] = seed;
  r->s[1] = r->mat1;
  r->s[2] = r->mat2;
  r->s[3] = r->tmat;
  for (uint32_t i = 1; i < 8; ++i) {
    uint32_t prev = r->s[(i - 1) & 3];
    r->s[i & 3] ^= i + 1812433253u * (prev ^ (prev >> 30));
  }
  if ((r->s[0] & 0x7FFFFFFFu) == 0 && r->s[1] == 0 && r->s[2] == 0 &&
      r->s[3] == 0) {
    r->s[0] = 'T';
    r->s[1] = 'I';
    r->s[2] = 'N';
    r->s[3] = 'Y';
  }
  for (int i = 0; i < 8; ++i) tinymt_next(r);
}

// ---------------------------------------------------------------------------
// Sampler: threefry counter mode or per-pixel TinyMT state mode.
// ---------------------------------------------------------------------------

struct Sampler {
  int mode;  // 0 = threefry, 1 = tinymt
  // threefry
  uint32_t seed, stream;
  uint32_t pixel, base;
  int pair;
  bool has_spare = false;
  float spare = 0.0f;
  // tinymt (borrowed pointer into the caller's state planes)
  TinyMT tm;

  void draw2(float* u1, float* u2) {
    if (mode == 0) {
      uint32_t a, b;
      threefry2x32(seed, stream, pixel, base + static_cast<uint32_t>(pair++),
                   &a, &b);
      *u1 = uniform_oo(a);
      *u2 = uniform_oo(b);
    } else {
      *u1 = tinymt_float_oo(&tm);
      *u2 = tinymt_float_oo(&tm);
    }
  }
  float draw1() {
    if (mode == 0) {
      // Sibling caching mirrors the JAX ThreefrySampler: paired draw1 call
      // sites share one threefry block (rng/sampler.py).
      if (has_spare) {
        has_spare = false;
        return spare;
      }
      float a, b;
      draw2(&a, &b);
      spare = b;
      has_spare = true;
      return a;
    }
    return tinymt_float_oo(&tm);
  }
};

// ---------------------------------------------------------------------------
// Math helpers (mirroring l2n.maths.sampling / ops.envlight).
// ---------------------------------------------------------------------------

struct V3 {
  float x, y, z;
};
inline V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline V3 operator*(float s, V3 a) { return {s * a.x, s * a.y, s * a.z}; }
inline float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline V3 normalize(V3 a) {
  float r = 1.0f / std::sqrt(dot(a, a));
  return r * a;
}

// Same minimax atan2 polynomial as maths/fastmath.py so env parity is tight.
inline float poly_atan2(float y, float x) {
  static const float C[6] = {0.99997726f, -0.33262347f, 0.19354346f,
                             -0.11643287f, 0.05265332f, -0.01172120f};
  float ax = std::fabs(x), ay = std::fabs(y);
  float hi = ax > ay ? ax : ay;
  float lo = ax > ay ? ay : ax;
  float t = lo / (hi > 1e-37f ? hi : 1e-37f);
  float s = t * t;
  float p = C[5];
  for (int i = 4; i >= 0; --i) p = p * s + C[i];
  float a = t * p;
  if (ay > ax) a = 1.5707964f - a;
  if (x < 0.0f) a = 3.1415927f - a;
  return y < 0.0f ? -a : a;
}

constexpr float kPi = 3.14159265358979323846f;

// frameZ (sphere_pathtracing.cs.glsl:102-117).
inline void frame_z(V3 z, V3* t, V3* b) {
  if (std::fabs(z.y) > std::fabs(z.x)) {
    float rcp = 1.0f / std::sqrt(z.x * z.x + z.y * z.y);
    *t = {rcp * z.y, -rcp * z.x, 0.0f};
  } else {
    float rcp = 1.0f / std::sqrt(z.x * z.x + z.z * z.z);
    *t = {rcp * z.z, 0.0f, -rcp * z.x};
  }
  *b = cross(z, *t);
}

inline V3 cosine_hemisphere(float u1, float u2) {
  float r = std::sqrt(u1);
  float phi = 2.0f * kPi * u2;
  float ct = std::sqrt(u1 < 1.0f ? 1.0f - u1 : 0.0f);
  return {r * std::cos(phi), r * std::sin(phi), ct};
}

inline V3 albedo_of(int32_t n) {
  // fract(sin((n+1)*k)*43758.5453) (glsl:215-222).
  float f = static_cast<float>(n + 1);
  auto chan = [&](float k) {
    float v = std::sin(f * k) * 43758.5453f;
    return v - std::floor(v);
  };
  return {chan(12.9898f), chan(78.233f), chan(56.128f)};
}

inline float luminance(V3 c) {
  return 0.212671f * c.x + 0.715160f * c.y + 0.072169f * c.z;
}

// ---------------------------------------------------------------------------
// Microfacet BSDF (material_mode == 1): the C++ twin of
// l2n/maths/brdf.py (GGX NDF + Smith height-correlated visibility +
// Schlick Fresnel over a (1 - F) Lambert lobe, sampled as a 50/50
// cosine/GGX mixture). Same formulas, same epsilons, same draw order
// (u1, u2 pair then u_lobe) as the JAX sampler so images agree
// statistically across all three implementations.
// ---------------------------------------------------------------------------

constexpr float kF0Dielectric = 0.04f;  // brdf.py F0_DIELECTRIC

inline float procedural_roughness_of(int32_t index) {
  float f = static_cast<float>(index + 1);
  float v = std::sin(f * 39.425f) * 43758.5453f;
  return 0.08f + 0.92f * (v - std::floor(v));
}

struct BrdfVal {
  V3 f;
  float pdf;
};

inline BrdfVal eval_brdf(V3 n, V3 wo, V3 wi, V3 kd, float rough) {
  float alpha = rough * rough;
  float alpha2 = alpha * alpha;
  float n_v = std::max(dot(n, wo), 1e-6f);
  float n_l = std::max(dot(n, wi), 0.0f);
  V3 h = normalize(wo + wi);
  float n_h = std::max(dot(n, h), 0.0f);
  float v_h = std::max(dot(wo, h), 1e-6f);
  float dden = n_h * n_h * (alpha2 - 1.0f) + 1.0f;
  float d = alpha2 / std::max(kPi * dden * dden, 1e-12f);
  float gv = n_l * std::sqrt(n_v * n_v * (1.0f - alpha2) + alpha2);
  float gl = n_v * std::sqrt(n_l * n_l * (1.0f - alpha2) + alpha2);
  float vis = 0.5f / std::max(gv + gl, 1e-12f);
  float om = std::max(1.0f - v_h, 0.0f);
  float m2 = om * om;
  float fr = kF0Dielectric + (1.0f - kF0Dielectric) * (m2 * m2 * om);
  float spec = d * vis * fr;
  float kdiff = (1.0f / kPi) * (1.0f - fr);
  float pdf_cos = n_l * (1.0f / kPi);
  float pdf_ggx = d * n_h / std::max(4.0f * v_h, 1e-6f);
  float pdf = 0.5f * (pdf_cos + pdf_ggx);
  if (!(n_l > 0.0f)) return {{0.0f, 0.0f, 0.0f}, 0.0f};
  return {{kd.x * kdiff + spec, kd.y * kdiff + spec, kd.z * kdiff + spec},
          pdf};
}

// Disney principled (lite) — the C++ twin of brdf.py's eval_disney /
// sample_disney / procedural_disney_params: Burley retro-reflective
// diffuse with the Hanrahan-Krueger subsurface blend, sheen, colored-
// Fresnel GGX, metallic-weighted cosine/GGX mixture sampling.

struct DisneyParams {
  float metallic, specular, sheen, subsurface;
};

inline DisneyParams disney_params_of(int32_t index) {
  float f = static_cast<float>(index + 1);
  auto chan = [&](float k) {
    float v = std::sin(f * k) * 43758.5453f;
    return v - std::floor(v);
  };
  float raw_metal = chan(57.731f);
  float metallic = 0.0f;
  if (raw_metal > 0.75f) {
    metallic = (raw_metal - 0.75f) * 8.0f;
    if (metallic > 1.0f) metallic = 1.0f;
  }
  float raw_ss = chan(31.337f);
  float subsurface = raw_ss > 0.5f ? (raw_ss - 0.5f) * 2.0f : 0.0f;
  return {metallic, chan(23.147f), chan(11.519f), subsurface};
}

inline float schlick5(float x) {
  float om = std::max(1.0f - x, 0.0f);
  float m2 = om * om;
  return m2 * m2 * om;
}

inline BrdfVal eval_disney(V3 n, V3 wo, V3 wi, V3 base, float rough,
                           DisneyParams dp) {
  float alpha = rough * rough;
  float alpha2 = alpha * alpha;
  float n_v = std::max(dot(n, wo), 1e-6f);
  float n_l = std::max(dot(n, wi), 0.0f);
  V3 h = normalize(wo + wi);
  float n_h = std::max(dot(n, h), 0.0f);
  float v_h = std::max(dot(wo, h), 1e-6f);

  float dden = n_h * n_h * (alpha2 - 1.0f) + 1.0f;
  float d = alpha2 / std::max(kPi * dden * dden, 1e-12f);
  float gv = n_l * std::sqrt(n_v * n_v * (1.0f - alpha2) + alpha2);
  float gl = n_v * std::sqrt(n_l * n_l * (1.0f - alpha2) + alpha2);
  float vis = 0.5f / std::max(gv + gl, 1e-12f);
  float s5 = schlick5(v_h);
  float f0_d = 0.08f * dp.specular;
  V3 f0{f0_d + (base.x - f0_d) * dp.metallic,
        f0_d + (base.y - f0_d) * dp.metallic,
        f0_d + (base.z - f0_d) * dp.metallic};
  float dv = d * vis;
  V3 spec{dv * (f0.x + (1.0f - f0.x) * s5), dv * (f0.y + (1.0f - f0.y) * s5),
          dv * (f0.z + (1.0f - f0.z) * s5)};

  float sl = schlick5(n_l);
  float sv = schlick5(n_v);
  float fd90 = 0.5f + 2.0f * rough * v_h * v_h;
  float fd = (1.0f + (fd90 - 1.0f) * sl) * (1.0f + (fd90 - 1.0f) * sv);
  float fss90 = rough * v_h * v_h;
  float fss = (1.0f + (fss90 - 1.0f) * sl) * (1.0f + (fss90 - 1.0f) * sv);
  float ss = 1.25f * (fss * (1.0f / std::max(n_l + n_v, 1e-6f) - 0.5f)
                      + 0.5f);
  float kdiff = (1.0f / kPi) * (fd + (ss - fd) * dp.subsurface) *
                (1.0f - dp.metallic);
  float fsheen = dp.sheen * s5 * (1.0f - dp.metallic);

  float p_spec = 0.25f + 0.5f * dp.metallic;
  float pdf_cos = n_l * (1.0f / kPi);
  float pdf_ggx = d * n_h / std::max(4.0f * v_h, 1e-6f);
  float pdf = p_spec * pdf_ggx + (1.0f - p_spec) * pdf_cos;
  if (!(n_l > 0.0f)) return {{0.0f, 0.0f, 0.0f}, 0.0f};
  return {{base.x * kdiff + fsheen + spec.x,
           base.y * kdiff + fsheen + spec.y,
           base.z * kdiff + fsheen + spec.z},
          pdf};
}

inline V3 sample_disney(float u_lobe, float u1, float u2, V3 n, V3 t, V3 b,
                        V3 wo, V3 base, float rough, DisneyParams dp,
                        V3* w) {
  float alpha = rough * rough;
  float alpha2 = alpha * alpha;
  V3 cl = cosine_hemisphere(u1, u2);
  V3 a{t.x * cl.x + b.x * cl.y + n.x * cl.z,
       t.y * cl.x + b.y * cl.y + n.y * cl.z,
       t.z * cl.x + b.z * cl.y + n.z * cl.z};
  float cos_h = std::sqrt(std::max(
      (1.0f - u1) / std::max(1.0f + (alpha2 - 1.0f) * u1, 1e-12f), 0.0f));
  float sin_h = std::sqrt(std::max(1.0f - cos_h * cos_h, 0.0f));
  float phi = 2.0f * kPi * u2;
  float hx = sin_h * std::cos(phi), hy = sin_h * std::sin(phi);
  V3 hv{t.x * hx + b.x * hy + n.x * cos_h,
        t.y * hx + b.y * hy + n.y * cos_h,
        t.z * hx + b.z * hy + n.z * cos_h};
  float v_h = dot(wo, hv);
  V3 refl = 2.0f * v_h * hv - wo;
  float p_spec = 0.25f + 0.5f * dp.metallic;
  V3 wi = normalize(u_lobe < p_spec ? refl : a);
  BrdfVal e = eval_disney(n, wo, wi, base, rough, dp);
  float n_l = std::max(dot(n, wi), 0.0f);
  float scale = n_l / std::max(e.pdf, 1e-12f);
  if (e.pdf > 0.0f) {
    *w = {e.f.x * scale, e.f.y * scale, e.f.z * scale};
  } else {
    *w = {0.0f, 0.0f, 0.0f};
  }
  return wi;
}

// Returns the sampled direction; *w is the estimator weight f*cos/pdf.
inline V3 sample_brdf(float u_lobe, float u1, float u2, V3 n, V3 t, V3 b,
                      V3 wo, V3 kd, float rough, V3* w) {
  float alpha = rough * rough;
  float alpha2 = alpha * alpha;
  V3 cl = cosine_hemisphere(u1, u2);
  V3 a{t.x * cl.x + b.x * cl.y + n.x * cl.z,
       t.y * cl.x + b.y * cl.y + n.y * cl.z,
       t.z * cl.x + b.z * cl.y + n.z * cl.z};
  float cos_h = std::sqrt(std::max(
      (1.0f - u1) / std::max(1.0f + (alpha2 - 1.0f) * u1, 1e-12f), 0.0f));
  float sin_h = std::sqrt(std::max(1.0f - cos_h * cos_h, 0.0f));
  float phi = 2.0f * kPi * u2;
  float hx = sin_h * std::cos(phi), hy = sin_h * std::sin(phi);
  V3 hv{t.x * hx + b.x * hy + n.x * cos_h,
        t.y * hx + b.y * hy + n.y * cos_h,
        t.z * hx + b.z * hy + n.z * cos_h};
  float v_h = dot(wo, hv);
  V3 refl = 2.0f * v_h * hv - wo;
  V3 wi = normalize(u_lobe < 0.5f ? refl : a);
  BrdfVal e = eval_brdf(n, wo, wi, kd, rough);
  float n_l = std::max(dot(n, wi), 0.0f);
  float scale = n_l / std::max(e.pdf, 1e-12f);
  if (e.pdf > 0.0f) {
    *w = {e.f.x * scale, e.f.y * scale, e.f.z * scale};
  } else {
    *w = {0.0f, 0.0f, 0.0f};
  }
  return wi;
}

inline float mandelbrot_le(V3 d) {
  float sin_t = std::sqrt(d.x * d.x + d.y * d.y);
  float theta = poly_atan2(sin_t, d.z);
  float phi = poly_atan2(d.y, d.x);
  float u = phi / kPi;
  float v = -1.0f + 2.0f * theta / kPi;
  float px = 8.0f * u, py = 4.0f * v;
  float zx = 0.0f, zy = 0.0f;
  for (int i = 0; i < 64; ++i) {
    float nx = zx * zx - zy * zy + px;
    float ny = 2.0f * zx * zy + py;
    zx = nx;
    zy = ny;
    if (zx * zx + zy * zy > 4.0f) return static_cast<float>(i) / 64.0f;
  }
  return 0.0f;
}

inline float sun_le(V3 d) {
  const float s = 0.57735027f;  // normalize(1,1,-1)
  float c = s * d.x + s * d.y - s * d.z;
  if (c <= 0.0f) return 0.0f;
  float p = c;
  for (int i = 0; i < 7; ++i) p *= p;  // c^128
  return p;
}

// ---------------------------------------------------------------------------
// Scene + config plumbed from Python (packed camera layout = camera.py).
// ---------------------------------------------------------------------------

struct Config {
  int32_t width, height;          // visible image size (NDC denominators)
  int32_t buf_width, buf_height;  // padded plane dims
  int32_t tile_width, tile_height;
  int32_t max_bounces;
  int32_t emissive_every;
  float emission_scale;
  float rr_ceiling;
  float ray_epsilon;
  int32_t env_mode;  // 0 none, 1 mandelbrot, 2 sun
  float env_scale;
  float gamma;
  int32_t rng_mode;  // 0 threefry, 1 tinymt
  uint32_t seed;
  uint32_t stream;
  int32_t max_pairs;
  int32_t ray_gen;  // 0 fovy, 1 viewproj
  int32_t aov;      // 0 pathtracing, 1 normal, 2 hit
  int32_t nee;      // next event estimation (threefry only)
  float normal_map;       // procedural bump strength (0 = off)
  float normal_map_freq;  // bump field wavenumber
  int32_t material_mode;  // 0 procedural Lambert, 1 microfacet (GGX+Lambert)
};

// Procedural normal mapping (wishlist TODO.md:5) — the C++ twin of
// l2n/maths/bump.py: world-space sine height field, per-object
// amplitude from the albedo's fract(sin) hash family, Blinn bump
//   n' = normalize(n - (g - (g.n) n)),  g = A (cos f*px, cos f*py, cos f*pz).
inline V3 bump_normal(const Config& cfg, int32_t index, V3 p, V3 n) {
  n = normalize(n);
  float f = static_cast<float>(index + 1);
  float v = std::sin(f * 91.173f) * 43758.5453f;
  float amp = cfg.normal_map * (0.25f + 0.75f * (v - std::floor(v)));
  V3 g{amp * std::cos(cfg.normal_map_freq * p.x),
       amp * std::cos(cfg.normal_map_freq * p.y),
       amp * std::cos(cfg.normal_map_freq * p.z)};
  float gn = dot(g, n);
  return normalize(
      V3{n.x - (g.x - gn * n.x), n.y - (g.y - gn * n.y),
         n.z - (g.z - gn * n.z)});
}

struct Hit {
  float t;  // -1 miss
  V3 n;
  int32_t index;
  float r2;
};

inline Hit intersect_scene(const float* spheres, int n, V3 org, V3 dir) {
  // intersectScene (glsl:199-213): linear nearest-hit scan; t = t1 if
  // t1 >= 0 else t2.
  Hit h{-1.0f, {0, 0, 0}, -1, 1.0f};
  V3 best_c{0, 0, 0};
  for (int i = 0; i < n; ++i) {
    V3 c{spheres[4 * i], spheres[4 * i + 1], spheres[4 * i + 2]};
    float r2 = spheres[4 * i + 3];
    V3 co = org - c;
    float b = 2.0f * dot(co, dir);
    float cc = dot(co, co) - r2;
    float disc = b * b - 4.0f * cc;
    if (disc < 0.0f) continue;
    float sq = std::sqrt(disc);
    float t1 = 0.5f * (-b - sq);
    float t2 = 0.5f * (-b + sq);
    float t = t1 >= 0.0f ? t1 : t2;
    if (t >= 0.0f && (h.t < 0.0f || t < h.t)) {
      h.t = t;
      h.index = i;
      h.r2 = r2;
      best_c = c;
    }
  }
  if (h.t >= 0.0f) h.n = normalize(org + h.t * dir - best_c);
  return h;
}

// pathtracing with the GPU kernel's semantics (glsl:272-317), plus optional
// next event estimation mirroring l2n.ops.nee (same draw order as the
// JAX trace_path: hemisphere pair, NEE pick, NEE point pair, RR spare).
V3 trace_path(const Config& cfg, const float* spheres, int n, V3 org, V3 dir,
              Sampler* rng) {
  const int n_lights =
      (n + cfg.emissive_every - 1) / cfg.emissive_every;
  V3 tp{1, 1, 1}, col{0, 0, 0};
  bool emission_ok = true;
  Hit h = intersect_scene(spheres, n, org, dir);
  float dist = h.t;
  for (int bounce = 0; bounce < cfg.max_bounces && dist >= 0.0f; ++bounce) {
    if (h.index % cfg.emissive_every == 0) {
      if (!cfg.nee || emission_ok) {
        float e = cfg.emission_scale / (4.0f * kPi * h.r2);
        col = col + e * tp;
      }
      dist = -2.0f;
      break;
    }
    org = org + h.t * dir;
    if (cfg.normal_map > 0.0f) h.n = bump_normal(cfg, h.index, org, h.n);
    V3 t, b;
    frame_z(h.n, &t, &b);
    float u1, u2;
    rng->draw2(&u1, &u2);
    V3 kd = albedo_of(h.index);
    const int mat = cfg.material_mode;  // 0 lambert, 1 microfacet, 2 disney
    V3 wo = -1.0f * dir;
    float rough = 0.0f;
    DisneyParams dp{};
    V3 newdir, bsdf_w;
    if (mat != 0) {
      // Draw order mirrors the JAX material branch: (u1, u2) then u_lobe.
      float u_lobe = rng->draw1();
      rough = procedural_roughness_of(h.index);
      if (mat == 2) {
        dp = disney_params_of(h.index);
        newdir = sample_disney(u_lobe, u1, u2, h.n, t, b, wo, kd, rough,
                               dp, &bsdf_w);
      } else {
        newdir = sample_brdf(u_lobe, u1, u2, h.n, t, b, wo, kd, rough,
                             &bsdf_w);
      }
    } else {
      V3 l = cosine_hemisphere(u1, u2);
      newdir = normalize(V3{t.x * l.x + b.x * l.y + h.n.x * l.z,
                            t.y * l.x + b.y * l.y + h.n.y * l.z,
                            t.z * l.x + b.z * l.y + h.n.z * l.z});
      bsdf_w = kd;
    }

    if (cfg.nee) {
      float u_pick = rng->draw1();
      float ul1, ul2;
      rng->draw2(&ul1, &ul2);
      int pick = static_cast<int>(u_pick * n_lights);
      if (pick >= n_lights) pick = n_lights - 1;
      int li = pick * cfg.emissive_every;
      V3 c{spheres[4 * li], spheres[4 * li + 1], spheres[4 * li + 2]};
      float r = std::sqrt(spheres[4 * li + 3]);
      float z = 1.0f - 2.0f * ul1;
      float s = std::sqrt(z * z < 1.0f ? 1.0f - z * z : 0.0f);
      float phi = 2.0f * kPi * ul2;
      V3 nl{s * std::cos(phi), s * std::sin(phi), z};
      V3 p = c + r * nl;
      V3 to_l = p - org;
      float d2 = dot(to_l, to_l);
      float rdist = 1.0f / std::sqrt(d2 > 1e-20f ? d2 : 1e-20f);
      V3 ldir = rdist * to_l;
      float cos_s = dot(h.n, ldir);
      float cos_l = -dot(nl, ldir);
      if (cos_s > 0.0f && cos_l > 0.0f) {
        Hit sh = intersect_scene(spheres, n,
                                 org + cfg.ray_epsilon * ldir, ldir);
        if (sh.index == li) {
          // f is kd/pi (Lambert) or the full material eval; the common
          // factor mirrors nee_contribution (ops/nee.py).
          float base = cfg.emission_scale * n_lights * cos_s * cos_l /
                       (d2 > 1e-20f ? d2 : 1e-20f);
          V3 f = mat == 2 ? eval_disney(h.n, wo, ldir, kd, rough, dp).f
                 : mat == 1 ? eval_brdf(h.n, wo, ldir, kd, rough).f
                            : (1.0f / kPi) * kd;
          col = col + V3{tp.x * f.x * base, tp.y * f.y * base,
                         tp.z * f.z * base};
        }
      }
      emission_ok = false;
    }

    dir = newdir;
    tp = {tp.x * bsdf_w.x, tp.y * bsdf_w.y, tp.z * bsdf_w.z};
    float rr = rng->draw1();
    float p = luminance(tp);
    if (p > cfg.rr_ceiling) p = cfg.rr_ceiling;
    if (rr < p) {
      tp = (1.0f / p) * tp;
      h = intersect_scene(spheres, n, org + cfg.ray_epsilon * dir, dir);
      dist = h.t;
    } else {
      dist = -2.0f;
    }
  }
  if (dist == -1.0f && h.index % cfg.emissive_every != 0 && cfg.env_mode != 0) {
    float le = cfg.env_mode == 1 ? mandelbrot_le(dir) : sun_le(dir);
    col = col + (cfg.env_scale * le) * tp;
  }
  return col;
}

// ---------------------------------------------------------------------------
// Triangle scene (the reference's second renderer,
// src/shaders/triangle_pathtracing.cs.glsl): flat triangle soup with
// precomputed edges + affine attribute deltas, Möller-Trumbore nearest hit,
// interpolated UNNORMALIZED normals (glsl:186-187), emissive sqrRadius = 1
// (glsl:268). Layout per triangle (18 floats):
//   v1(3) e1(3) e2(3) na(3) dnb(3) dnc(3); mesh ids ride separately.
// ---------------------------------------------------------------------------

struct TriSceneView {
  const float* tris;
  const int32_t* mesh;
  int32_t count;

  // Triangle AOVs miss to magenta (triangle_pathtracing.cs.glsl:340).
  V3 normal_miss() const { return {1.0f, 0.0f, 1.0f}; }

  Hit intersect(V3 org, V3 dir) const {
    const float kEps = 1e-6f;
    Hit h{-1.0f, {0, 0, 0}, -1, 1.0f};
    float best = 3.0e38f;
    float bu = 0.0f, bv = 0.0f;
    int32_t bi = -1;
    for (int32_t i = 0; i < count; ++i) {
      const float* d = tris + 18 * i;
      V3 v1{d[0], d[1], d[2]};
      V3 e1{d[3], d[4], d[5]};
      V3 e2{d[6], d[7], d[8]};
      V3 pv = cross(dir, e2);
      float det = dot(e1, pv);
      if (std::fabs(det) < kEps) continue;
      float rcp = 1.0f / det;
      V3 tv = org - v1;
      float u = dot(tv, pv) * rcp;
      if (u < 0.0f || u > 1.0f) continue;
      V3 qv = cross(tv, e1);
      float v = dot(dir, qv) * rcp;
      if (v < 0.0f || u + v > 1.0f) continue;
      float th = dot(e2, qv) * rcp;
      if (th < kEps || th >= best) continue;
      best = th;
      bu = u;
      bv = v;
      bi = i;
    }
    if (bi >= 0) {
      const float* d = tris + 18 * bi;
      h.t = best;
      h.n = {d[9] + bu * d[12] + bv * d[15],
             d[10] + bu * d[13] + bv * d[16],
             d[11] + bu * d[14] + bv * d[17]};
      h.index = mesh[bi];
      h.r2 = 1.0f;  // glsl:268
    }
    return h;
  }
};

struct SphereSceneView {
  const float* spheres;
  int32_t count;
  // Sphere normal AOV misses to black (sphere_pathtracing.cs.glsl:350).
  V3 normal_miss() const { return {0.0f, 0.0f, 0.0f}; }
  Hit intersect(V3 org, V3 dir) const {
    return intersect_scene(spheres, count, org, dir);
  }
};

// trace_path for scenes without the sphere NEE path (triangle scenes; the
// sphere variant with NEE keeps its own function above). Same structure as
// the GPU kernels (glsl:250-299). With cfg.nee, `bounds` carries the
// per-mesh bounding spheres (4 floats each) and direct light uses CONE
// (solid-angle) sampling over the picked emissive mesh's bound — the C++
// twin of l2n.ops.nee.nee_cone_contribution with the identical
// threefry draw order (hemisphere pair, pick, point pair, RR spare).
template <class SceneT>
V3 trace_path_generic(const Config& cfg, const SceneT& scene, V3 org, V3 dir,
                      Sampler* rng, const float* bounds = nullptr,
                      int32_t mesh_count = 0) {
  const bool nee = cfg.nee && bounds != nullptr;
  const int n_lights =
      nee ? (mesh_count + cfg.emissive_every - 1) / cfg.emissive_every : 0;
  V3 tp{1, 1, 1}, col{0, 0, 0};
  bool emission_ok = true;
  Hit h = scene.intersect(org, dir);
  float dist = h.t;
  for (int bounce = 0; bounce < cfg.max_bounces && dist >= 0.0f; ++bounce) {
    if (h.index % cfg.emissive_every == 0) {
      if (!nee || emission_ok) {
        float e = cfg.emission_scale / (4.0f * kPi * h.r2);
        col = col + V3{e * tp.x, e * tp.y, e * tp.z};
      }
      dist = -2.0f;
      break;
    }
    org = org + h.t * dir;
    if (cfg.normal_map > 0.0f) h.n = bump_normal(cfg, h.index, org, h.n);
    V3 kd = albedo_of(h.index);
    const int mat = cfg.material_mode;  // 0 lambert, 1 microfacet, 2 disney
    V3 wo = -1.0f * dir;
    V3 nn = normalize(h.n);  // material mode shades about the unit normal
    float rough = 0.0f;
    DisneyParams dp{};
    float u1, u2;
    rng->draw2(&u1, &u2);
    V3 newdir, bsdf_w;
    if (mat != 0) {
      float u_lobe = rng->draw1();
      rough = procedural_roughness_of(h.index);
      V3 t, b;
      frame_z(nn, &t, &b);
      if (mat == 2) {
        dp = disney_params_of(h.index);
        newdir = sample_disney(u_lobe, u1, u2, nn, t, b, wo, kd, rough,
                               dp, &bsdf_w);
      } else {
        newdir = sample_brdf(u_lobe, u1, u2, nn, t, b, wo, kd, rough,
                             &bsdf_w);
      }
    } else {
      V3 t, b;
      frame_z(h.n, &t, &b);  // reference keeps the unnormalized frame
      V3 l = cosine_hemisphere(u1, u2);
      newdir = normalize(V3{t.x * l.x + b.x * l.y + h.n.x * l.z,
                            t.y * l.x + b.y * l.y + h.n.y * l.z,
                            t.z * l.x + b.z * l.y + h.n.z * l.z});
      bsdf_w = kd;
    }

    if (nee) {
      float u_pick = rng->draw1();
      float ul1, ul2;
      rng->draw2(&ul1, &ul2);
      int pick = static_cast<int>(u_pick * n_lights);
      if (pick >= n_lights) pick = n_lights - 1;
      int li = pick * cfg.emissive_every;
      V3 c{bounds[4 * li], bounds[4 * li + 1], bounds[4 * li + 2]};
      float br2 = bounds[4 * li + 3];
      V3 w = c - org;
      float d2 = dot(w, w);
      // Omega = 2 pi (1 - cos_max); the full sphere when inside the bound
      // (ops/nee.py cone_solid_angle).
      float cos_max;
      if (d2 <= br2) {
        cos_max = -1.0f;
      } else {
        float v = 1.0f - br2 / (d2 > 1e-20f ? d2 : 1e-20f);
        cos_max = std::sqrt(v > 0.0f ? v : 0.0f);
      }
      float omega = 2.0f * kPi * (1.0f - cos_max);
      V3 axis = normalize(w);
      float cos_t = 1.0f - ul1 * (1.0f - cos_max);
      float st2 = 1.0f - cos_t * cos_t;
      float sin_t = std::sqrt(st2 > 0.0f ? st2 : 0.0f);
      float phi = 2.0f * kPi * ul2;
      V3 ta, ba;
      frame_z(axis, &ta, &ba);
      float lx = sin_t * std::cos(phi), ly = sin_t * std::sin(phi);
      V3 ldir{ta.x * lx + ba.x * ly + axis.x * cos_t,
              ta.y * lx + ba.y * ly + axis.y * cos_t,
              ta.z * lx + ba.z * ly + axis.z * cos_t};
      Hit sh = scene.intersect(org + cfg.ray_epsilon * ldir, ldir);
      if (sh.t >= 0.0f && sh.index == li) {
        float cos_s = dot(nn, ldir);
        if (cos_s < 0.0f) cos_s = 0.0f;
        // Le = scale/(4 pi * 1): meshes emit with sqrRadius = 1
        // (triangle_pathtracing.cs.glsl:268); f = kd/pi or the full
        // material eval (nee_cone_contribution's brdf_eval path).
        float wgt = cos_s * (cfg.emission_scale / (4.0f * kPi)) *
                    static_cast<float>(n_lights) * omega;
        V3 f = mat == 2 ? eval_disney(nn, wo, ldir, kd, rough, dp).f
               : mat == 1 ? eval_brdf(nn, wo, ldir, kd, rough).f
                          : (1.0f / kPi) * kd;
        col = col + V3{tp.x * f.x * wgt, tp.y * f.y * wgt,
                       tp.z * f.z * wgt};
      }
      emission_ok = false;
    }

    dir = newdir;
    tp = {tp.x * bsdf_w.x, tp.y * bsdf_w.y, tp.z * bsdf_w.z};
    float rr = rng->draw1();
    float p = luminance(tp);
    if (p > cfg.rr_ceiling) p = cfg.rr_ceiling;
    if (rr < p) {
      tp = (1.0f / p) * tp;
      h = scene.intersect(org + cfg.ray_epsilon * dir, dir);
      dist = h.t;
    } else {
      dist = -2.0f;
    }
  }
  if (dist == -1.0f && h.index % cfg.emissive_every != 0 &&
      cfg.env_mode != 0) {
    float le = cfg.env_mode == 1 ? mandelbrot_le(dir) : sun_le(dir);
    col = col + (cfg.env_scale * le) * tp;
  }
  return col;
}

template <class SceneT>
int32_t render_tiles_impl(const Config* cfg, const SceneT& scene,
                          const float* camera, const int32_t* tiles,
                          int32_t tile_count, int32_t offset, int32_t count,
                          float* accum, float* output, uint32_t* rng_state,
                          int32_t num_threads, const float* nee_spheres,
                          int32_t nee_sphere_count,
                          const float* mesh_bounds = nullptr,
                          int32_t mesh_count = 0) {
  const int W = cfg->buf_width, H = cfg->buf_height;
  const int64_t plane = static_cast<int64_t>(W) * H;
  const V3 cam_pos{camera[4 * 8 + 0], camera[4 * 8 + 1], camera[4 * 8 + 2]};
  const float ratio = camera[4 * 9 + 0];
  const float tan_half = camera[4 * 9 + 1];

  int threads = num_threads > 0
                    ? num_threads
                    : static_cast<int>(std::thread::hardware_concurrency());
  if (threads < 1) threads = 1;
  std::atomic<int32_t> next_tile{0};

  auto worker = [&]() {
    int32_t ti;
    while ((ti = next_tile.fetch_add(1)) < count) {
      int32_t slot = (ti + offset) % tile_count;
      int32_t tx = tiles[2 * slot], ty = tiles[2 * slot + 1];
      for (int py = ty * cfg->tile_height;
           py < (ty + 1) * cfg->tile_height && py < H; ++py) {
        for (int px = tx * cfg->tile_width;
             px < (tx + 1) * cfg->tile_width && px < W; ++px) {
          const int64_t pix = static_cast<int64_t>(py) * W + px;

          Sampler rng{};
          rng.mode = cfg->rng_mode;
          if (cfg->rng_mode == 0) {
            rng.seed = cfg->seed;
            rng.stream = cfg->stream;
            rng.pixel = static_cast<uint32_t>(pix);
            rng.base = static_cast<uint32_t>(accum[3 * plane + pix]) *
                       static_cast<uint32_t>(cfg->max_pairs);
            rng.pair = 0;
          } else {
            for (int wdx = 0; wdx < 4; ++wdx)
              rng.tm.s[wdx] = rng_state[wdx * plane + pix];
            rng.tm.mat1 = rng_state[4 * plane + pix];
            rng.tm.mat2 = rng_state[5 * plane + pix];
            rng.tm.tmat = rng_state[6 * plane + pix];
          }

          float u1, u2;
          rng.draw2(&u1, &u2);  // pixel jitter (glsl:371)
          float sx = (static_cast<float>(px) + u1) / cfg->width;
          float sy = (static_cast<float>(py) + u2) / cfg->height;
          float ndx = -1.0f + 2.0f * sx;
          float ndy = -1.0f + 2.0f * sy;

          V3 world;
          if (cfg->ray_gen == 0) {  // fovy trick (glsl:378-384)
            float vx = ndx * ratio * tan_half;
            float vy = ndy * tan_half;
            const float* m = camera;  // rows 0..3 = rcpView
            world = {m[0] * vx + m[1] * vy - m[2] + m[3],
                     m[4] * vx + m[5] * vy - m[6] + m[7],
                     m[8] * vx + m[9] * vy - m[10] + m[11]};
          } else {  // inverse view-projection (main.cpp:562-567)
            const float* m = camera + 16;  // rows 4..7
            float wx = m[0] * ndx + m[1] * ndy + m[2] + m[3];
            float wy = m[4] * ndx + m[5] * ndy + m[6] + m[7];
            float wz = m[8] * ndx + m[9] * ndy + m[10] + m[11];
            float ww = m[12] * ndx + m[13] * ndy + m[14] + m[15];
            world = (1.0f / ww) * V3{wx, wy, wz};
          }
          V3 dir = normalize(world - cam_pos);

          V3 color;
          if (cfg->aov == 1) {  // normal AOV
            Hit h = scene.intersect(cam_pos, dir);
            if (h.t >= 0.0f && cfg->normal_map > 0.0f)
              h.n = bump_normal(*cfg, h.index, cam_pos + h.t * dir, h.n);
            color = h.t >= 0.0f ? h.n : scene.normal_miss();
          } else if (cfg->aov == 2) {  // hit AOV
            Hit h = scene.intersect(cam_pos, dir);
            float v = h.t >= 0.0f ? 1.0f : 0.0f;
            color = {v, v, v};
          } else if (nee_spheres != nullptr) {
            // Sphere path keeps its NEE-capable tracer.
            color = trace_path(*cfg, nee_spheres, nee_sphere_count, cam_pos,
                               dir, &rng);
          } else {
            color = trace_path_generic(*cfg, scene, cam_pos, dir, &rng,
                                       mesh_bounds, mesh_count);
          }

          // newEstimate = current + (color, 1); out = pow(rgb/n, gamma)
          // (glsl:391-395).
          float nsamp = accum[3 * plane + pix] + 1.0f;
          accum[0 * plane + pix] += color.x;
          accum[1 * plane + pix] += color.y;
          accum[2 * plane + pix] += color.z;
          accum[3 * plane + pix] = nsamp;
          for (int c = 0; c < 3; ++c) {
            float mean = accum[c * plane + pix] / nsamp;
            output[c * plane + pix] =
                mean <= 0.0f ? 0.0f : std::pow(mean, cfg->gamma);
          }

          if (cfg->rng_mode == 1) {
            for (int wdx = 0; wdx < 4; ++wdx)
              rng_state[wdx * plane + pix] = rng.tm.s[wdx];
          }
        }
      }
    }
  };

  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int i = 0; i < threads; ++i) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return 0;
}

}  // namespace

extern "C" {

// RNG entry points for parity tests -----------------------------------------

void l2n_threefry2x32(uint32_t k0, uint32_t k1, const uint32_t* x0,
                      const uint32_t* x1, uint32_t* o0, uint32_t* o1,
                      int64_t n) {
  for (int64_t i = 0; i < n; ++i)
    threefry2x32(k0, k1, x0[i], x1[i], &o0[i], &o1[i]);
}

void l2n_tinymt_uint32(uint32_t mat1, uint32_t mat2, uint32_t tmat,
                       uint32_t seed, uint32_t* out, int64_t n) {
  TinyMT r{{0, 0, 0, 0}, mat1, mat2, tmat};
  tinymt_init(&r, seed);
  for (int64_t i = 0; i < n; ++i) {
    tinymt_next(&r);
    out[i] = tinymt_temper(&r);
  }
}

// The renderer ----------------------------------------------------------------
//
// accum/output are channel-major planes matching FrameState: accum
// (4, buf_height, buf_width), output (3, ...). camera is the packed (10, 4)
// block. tiles is (tile_count, 2) int32 (tx, ty); renders `count` tiles
// starting at `offset` with wraparound — renderTiles semantics
// (main.cpp:516-592). rng_state (tinymt mode): (8, H, W) uint32 planes,
// stepped in place. Returns 0 on success.

int32_t l2n_render_tiles(const Config* cfg, const float* spheres,
                         int32_t sphere_count, const float* camera,
                         const int32_t* tiles, int32_t tile_count,
                         int32_t offset, int32_t count, float* accum,
                         float* output, uint32_t* rng_state,
                         int32_t num_threads) {
  SphereSceneView scene{spheres, sphere_count};
  return render_tiles_impl(cfg, scene, camera, tiles, tile_count, offset,
                           count, accum, output, rng_state, num_threads,
                           spheres, sphere_count);
}

// Triangle-scene renderer (the reference's CPU renderer is sphere-only,
// src/main.cpp:206-599 — this goes beyond it so the framework has three
// independent implementations for BOTH scene families). Triangle layout:
// see TriSceneView. mesh_bounds: (mesh_count, 4) [cx cy cz r^2] bounding
// spheres feeding cone NEE when cfg->nee (may be null when !cfg->nee).
int32_t l2n_render_tiles_tri(const Config* cfg, const float* tris,
                             const int32_t* mesh_ids, int32_t tri_count,
                             const float* camera, const int32_t* tiles,
                             int32_t tile_count, int32_t offset,
                             int32_t count, float* accum, float* output,
                             uint32_t* rng_state, int32_t num_threads,
                             const float* mesh_bounds, int32_t mesh_count) {
  if (cfg->nee && mesh_bounds == nullptr) return 2;
  TriSceneView scene{tris, mesh_ids, tri_count};
  return render_tiles_impl(cfg, scene, camera, tiles, tile_count, offset,
                           count, accum, output, rng_state, num_threads,
                           nullptr, 0, mesh_bounds, mesh_count);
}

}  // extern "C"
