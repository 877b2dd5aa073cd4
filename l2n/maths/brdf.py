"""Microfacet BSDF (GGX/Trowbridge-Reitz + Lambert) — reference wishlist.

The reference's TODO lists "microfacet les brdfs" (l2n-renderer/TODO.md:5)
and declares Phong material buffers its shading never reads
(sphere_pathtracing.cs.glsl:9-38). This module implements the modern
standard instead: a Smith-GGX specular lobe with Schlick Fresnel over a
Lambertian base, importance-sampled as an equal-weight two-lobe mixture.

Everything is lane-lockstep SoA (no per-lane material gathers): per-object
roughness comes from the same procedural-hash family as the reference's
albedo (glsl:215-222), or from a caller-provided fetch closure — which is
how the declared-but-unused PhongMaterial buffers finally get wired in
(shininess -> roughness, diffuse -> albedo) via a select-sweep.

Estimator: one direction per vertex from the mixture
  pdf = 0.5 * pdf_cos + 0.5 * pdf_ggx
  weight = f(wo, wi) * cos(wi) / pdf        (unbiased single-sample mixture)
"""

from __future__ import annotations

import jax.numpy as jnp

from l2n.maths.sampling import PI, dot3, normalize3

F0_DIELECTRIC = 0.04  # 4% normal-incidence reflectance


def procedural_roughness(index):
    """Per-object roughness in [0.08, 1.0] from the reference's fract(sin)
    hash family (a 4th channel alongside glsl:215-222's three)."""
    f = (index + 1).astype(jnp.float32)
    v = jnp.sin(f * jnp.float32(39.425)) * jnp.float32(43758.5453)
    h = v - jnp.floor(v)
    return jnp.float32(0.08) + jnp.float32(0.92) * h


def _d_ggx(n_h, alpha2):
    d = n_h * n_h * (alpha2 - 1.0) + 1.0
    return alpha2 / jnp.maximum(jnp.float32(PI) * d * d, jnp.float32(1e-12))


def _g_smith(n_v, n_l, alpha2):
    """Smith height-correlated visibility (the G / (4 n.v n.l) form)."""
    gv = n_l * jnp.sqrt(n_v * n_v * (1.0 - alpha2) + alpha2)
    gl = n_v * jnp.sqrt(n_l * n_l * (1.0 - alpha2) + alpha2)
    return jnp.float32(0.5) / jnp.maximum(gv + gl, jnp.float32(1e-12))


def _fresnel(v_h):
    one_m = jnp.maximum(jnp.float32(1.0) - v_h, jnp.float32(0.0))
    m2 = one_m * one_m
    return jnp.float32(F0_DIELECTRIC) + jnp.float32(1.0 - F0_DIELECTRIC) * (
        m2 * m2 * one_m)


def eval_brdf(nx, ny, nz, wox, woy, woz, wix, wiy, wiz,
              kd_r, kd_g, kd_b, roughness):
    """(f_r, f_g, f_b, pdf) of the mixture BSDF for given directions.

    `n` must be unit; wo points away from the surface (toward the camera),
    wi toward the light. pdf is the sampling mixture's pdf for wi.
    """
    f32 = jnp.float32
    alpha = roughness * roughness
    alpha2 = alpha * alpha
    n_v = jnp.maximum(dot3(nx, ny, nz, wox, woy, woz), f32(1e-6))
    n_l = jnp.maximum(dot3(nx, ny, nz, wix, wiy, wiz), f32(0.0))
    hx, hy, hz = normalize3(wox + wix, woy + wiy, woz + wiz)
    n_h = jnp.maximum(dot3(nx, ny, nz, hx, hy, hz), f32(0.0))
    v_h = jnp.maximum(dot3(wox, woy, woz, hx, hy, hz), f32(1e-6))

    d = _d_ggx(n_h, alpha2)
    vis = _g_smith(n_v, n_l, alpha2)
    fr = _fresnel(v_h)
    spec = d * vis * fr  # scalar lobe (dielectric: white specular)

    kdiff = f32(1.0 / PI) * (f32(1.0) - fr)
    f_r = kd_r * kdiff + spec
    f_g = kd_g * kdiff + spec
    f_b = kd_b * kdiff + spec

    pdf_cos = n_l * f32(1.0 / PI)
    pdf_ggx = d * n_h / jnp.maximum(f32(4.0) * v_h, f32(1e-6))
    pdf = f32(0.5) * (pdf_cos + pdf_ggx)
    # Below-horizon directions carry nothing.
    ok = n_l > 0.0
    zero = f32(0.0)
    return (jnp.where(ok, f_r, zero), jnp.where(ok, f_g, zero),
            jnp.where(ok, f_b, zero), jnp.where(ok, pdf, zero))


# ---------------------------------------------------------------------------
# Disney "principled" BSDF (lite) — the reference wishlist's named model
# (l2n-renderer/TODO.md:5 "disney bsdf"). Implemented lobes: Burley
# retro-reflective diffuse, sheen, and a GGX specular with COLORED Fresnel
# (F0 = lerp(0.08*specular, baseColor, metallic)); metallic kills the
# diffuse/sheen terms. Subsurface is the diffusion-approximation blend
# (see eval_disney); clearcoat/anisotropy are out of scope.
# Sampling: metallic-weighted cosine/GGX mixture (unbiased single-sample
# estimator, same structure as the microfacet mixture above).
# ---------------------------------------------------------------------------

def procedural_disney_params(index):
    """Per-object (metallic, specular, sheen) from the reference's
    fract(sin) hash family (channels 5-7 alongside the albedo's three,
    glsl:215-222, and roughness's fourth). Metallic is thresholded so the
    scene reads as a mix of dielectrics and a few clear metals rather
    than uniformly half-metal mush."""
    f32 = jnp.float32
    f = (index + 1).astype(jnp.float32)

    def hash_ch(k):
        v = jnp.sin(f * f32(k)) * f32(43758.5453)
        return v - jnp.floor(v)

    raw_metal = hash_ch(57.731)
    metallic = jnp.where(raw_metal > 0.75,
                         jnp.minimum((raw_metal - f32(0.75)) * f32(8.0),
                                     f32(1.0)),
                         f32(0.0))
    specular = hash_ch(23.147)            # in [0, 1]; F0 = 0.08 * specular
    sheen = hash_ch(11.519)
    # Subsurface (wishlist l2n-renderer/TODO.md:17 'sub surface
    # scattering'): ~half the objects get a visible diffusion-approx
    # blend; the rest stay pure Burley. Metals ignore it (diffuse term
    # is killed by metallic in eval_disney either way).
    raw_ss = hash_ch(31.337)
    subsurface = jnp.maximum((raw_ss - f32(0.5)) * f32(2.0), f32(0.0))
    return metallic, specular, sheen, subsurface


def _schlick5(x):
    one_m = jnp.maximum(jnp.float32(1.0) - x, jnp.float32(0.0))
    m2 = one_m * one_m
    return m2 * m2 * one_m


def eval_disney(nx, ny, nz, wox, woy, woz, wix, wiy, wiz,
                base_r, base_g, base_b, roughness, metallic, specular,
                sheen, subsurface):
    """(f_r, f_g, f_b, pdf) of the Disney-lite BSDF for given directions.
    pdf is the metallic-weighted cosine/GGX sampling mixture's pdf.

    `subsurface` in [0, 1] blends the Burley diffuse toward the Disney
    diffusion-approximation lobe (Burley 2012 course notes §5.3, the
    Hanrahan-Krueger-inspired `ss` term): light enters, scatters below
    the surface, and re-emerges — flatter at normal incidence, brighter
    at mutually grazing angles via the 1/(n_l + n_v) term. This is the
    lane-lockstep answer to the reference wishlist's 'sub surface
    scattering' (l2n-renderer/TODO.md:17): a closed-form reciprocal
    lobe instead of a divergent in-medium random walk."""
    f32 = jnp.float32
    alpha = roughness * roughness
    alpha2 = alpha * alpha
    n_v = jnp.maximum(dot3(nx, ny, nz, wox, woy, woz), f32(1e-6))
    n_l = jnp.maximum(dot3(nx, ny, nz, wix, wiy, wiz), f32(0.0))
    hx, hy, hz = normalize3(wox + wix, woy + wiy, woz + wiz)
    n_h = jnp.maximum(dot3(nx, ny, nz, hx, hy, hz), f32(0.0))
    v_h = jnp.maximum(dot3(wox, woy, woz, hx, hy, hz), f32(1e-6))

    # Specular: GGX * Smith with per-channel Schlick Fresnel from
    # F0 = lerp(0.08 * specular, baseColor, metallic).
    d = _d_ggx(n_h, alpha2)
    vis = _g_smith(n_v, n_l, alpha2)
    s5 = _schlick5(v_h)
    f0_d = f32(0.08) * specular
    f0_r = f0_d + (base_r - f0_d) * metallic
    f0_g = f0_d + (base_g - f0_d) * metallic
    f0_b = f0_d + (base_b - f0_d) * metallic
    dv = d * vis
    spec_r = dv * (f0_r + (f32(1.0) - f0_r) * s5)
    spec_g = dv * (f0_g + (f32(1.0) - f0_g) * s5)
    spec_b = dv * (f0_b + (f32(1.0) - f0_b) * s5)

    # Burley diffuse: retro-reflection boost at grazing via FD90.
    sl = _schlick5(n_l)
    sv = _schlick5(n_v)
    fd90 = f32(0.5) + f32(2.0) * roughness * v_h * v_h
    fl = f32(1.0) + (fd90 - f32(1.0)) * sl
    fv = f32(1.0) + (fd90 - f32(1.0)) * sv
    fd = fl * fv
    # Subsurface: Hanrahan-Krueger-based diffusion approximation. fss90
    # reuses the same grazing retro term; 1.25 rescales so the lobe
    # roughly preserves albedo; the 1/(n_l+n_v) factor is the thin-slab
    # transport that brightens mutually grazing configurations.
    fss90 = roughness * v_h * v_h
    fss = (f32(1.0) + (fss90 - f32(1.0)) * sl) \
        * (f32(1.0) + (fss90 - f32(1.0)) * sv)
    ss = f32(1.25) * (fss * (f32(1.0) / jnp.maximum(n_l + n_v, f32(1e-6))
                             - f32(0.5)) + f32(0.5))
    kdiff = f32(1.0 / PI) * (fd + (ss - fd) * subsurface) \
        * (f32(1.0) - metallic)

    # Sheen: grazing-angle white lobe, dielectric only.
    fsheen = sheen * _schlick5(v_h) * (f32(1.0) - metallic)

    f_r = base_r * kdiff + fsheen + spec_r
    f_g = base_g * kdiff + fsheen + spec_g
    f_b = base_b * kdiff + fsheen + spec_b

    p_spec = f32(0.25) + f32(0.5) * metallic
    pdf_cos = n_l * f32(1.0 / PI)
    pdf_ggx = d * n_h / jnp.maximum(f32(4.0) * v_h, f32(1e-6))
    pdf = p_spec * pdf_ggx + (f32(1.0) - p_spec) * pdf_cos
    ok = n_l > 0.0
    zero = f32(0.0)
    return (jnp.where(ok, f_r, zero), jnp.where(ok, f_g, zero),
            jnp.where(ok, f_b, zero), jnp.where(ok, pdf, zero))


def sample_disney(u_lobe, u1, u2, nx, ny, nz, tangent, bitangent,
                  wox, woy, woz, base_r, base_g, base_b, roughness,
                  metallic, specular, sheen, subsurface):
    """Sample the metallic-weighted cosine/GGX mixture; returns
    (wix, wiy, wiz, w_r, w_g, w_b, pdf) with w = f * cos / pdf."""
    from l2n.maths.sampling import (
        cosine_sample_hemisphere,
        local_to_world,
    )
    f32 = jnp.float32
    alpha = roughness * roughness
    alpha2 = alpha * alpha

    (cx, cy, cz), _ = cosine_sample_hemisphere(u1, u2)
    ax, ay, az = local_to_world(cx, cy, cz, tangent, bitangent, (nx, ny, nz))

    cos_h = jnp.sqrt(jnp.maximum(
        (f32(1.0) - u1) / jnp.maximum(f32(1.0) + (alpha2 - 1.0) * u1,
                                      f32(1e-12)), f32(0.0)))
    sin_h = jnp.sqrt(jnp.maximum(f32(1.0) - cos_h * cos_h, f32(0.0)))
    phi = f32(2.0 * PI) * u2
    hx, hy, hz = local_to_world(sin_h * jnp.cos(phi), sin_h * jnp.sin(phi),
                                cos_h, tangent, bitangent, (nx, ny, nz))
    v_h = dot3(wox, woy, woz, hx, hy, hz)
    bx = f32(2.0) * v_h * hx - wox
    by = f32(2.0) * v_h * hy - woy
    bz = f32(2.0) * v_h * hz - woz

    p_spec = f32(0.25) + f32(0.5) * metallic
    pick_spec = u_lobe < p_spec
    wix = jnp.where(pick_spec, bx, ax)
    wiy = jnp.where(pick_spec, by, ay)
    wiz = jnp.where(pick_spec, bz, az)
    wix, wiy, wiz = normalize3(wix, wiy, wiz)

    f_r, f_g, f_b, pdf = eval_disney(
        nx, ny, nz, wox, woy, woz, wix, wiy, wiz,
        base_r, base_g, base_b, roughness, metallic, specular, sheen,
        subsurface)
    n_l = jnp.maximum(dot3(nx, ny, nz, wix, wiy, wiz), f32(0.0))
    scale = n_l / jnp.maximum(pdf, f32(1e-12))
    ok = pdf > 0.0
    zero = f32(0.0)
    return (wix, wiy, wiz,
            jnp.where(ok, f_r * scale, zero),
            jnp.where(ok, f_g * scale, zero),
            jnp.where(ok, f_b * scale, zero), pdf)


def sample_brdf(u_lobe, u1, u2, nx, ny, nz, tangent, bitangent,
                wox, woy, woz, kd_r, kd_g, kd_b, roughness):
    """Sample one direction from the 50/50 cosine/GGX mixture.

    Returns (wix, wiy, wiz, w_r, w_g, w_b, pdf) with w = f * cos / pdf —
    the factor multiplied into the path throughput — and the mixture pdf of
    the drawn direction (the BSDF side of MIS). `n` must be unit and
    (tangent, bitangent, n) an orthonormal-ish frame (frame_z's output).
    """
    from l2n.maths.sampling import (
        cosine_sample_hemisphere,
        local_to_world,
    )
    f32 = jnp.float32
    alpha = roughness * roughness
    alpha2 = alpha * alpha

    # Lobe A: cosine hemisphere.
    (cx, cy, cz), _ = cosine_sample_hemisphere(u1, u2)
    ax, ay, az = local_to_world(cx, cy, cz, tangent, bitangent, (nx, ny, nz))

    # Lobe B: GGX NDF half-vector, reflected.
    cos_h = jnp.sqrt(jnp.maximum(
        (f32(1.0) - u1) / jnp.maximum(f32(1.0) + (alpha2 - 1.0) * u1,
                                      f32(1e-12)), f32(0.0)))
    sin_h = jnp.sqrt(jnp.maximum(f32(1.0) - cos_h * cos_h, f32(0.0)))
    phi = f32(2.0 * PI) * u2
    hx, hy, hz = local_to_world(sin_h * jnp.cos(phi), sin_h * jnp.sin(phi),
                                cos_h, tangent, bitangent, (nx, ny, nz))
    v_h = dot3(wox, woy, woz, hx, hy, hz)
    bx = f32(2.0) * v_h * hx - wox
    by = f32(2.0) * v_h * hy - woy
    bz = f32(2.0) * v_h * hz - woz

    pick_spec = u_lobe < 0.5
    wix = jnp.where(pick_spec, bx, ax)
    wiy = jnp.where(pick_spec, by, ay)
    wiz = jnp.where(pick_spec, bz, az)
    wix, wiy, wiz = normalize3(wix, wiy, wiz)

    f_r, f_g, f_b, pdf = eval_brdf(nx, ny, nz, wox, woy, woz, wix, wiy, wiz,
                                   kd_r, kd_g, kd_b, roughness)
    n_l = jnp.maximum(dot3(nx, ny, nz, wix, wiy, wiz), f32(0.0))
    scale = n_l / jnp.maximum(pdf, f32(1e-12))
    ok = pdf > 0.0
    zero = f32(0.0)
    return (wix, wiy, wiz,
            jnp.where(ok, f_r * scale, zero),
            jnp.where(ok, f_g * scale, zero),
            jnp.where(ok, f_b * scale, zero), pdf)
