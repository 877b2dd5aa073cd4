"""Next event estimation (direct light sampling) and MIS.

An item from the reference's own wishlist (l2n-renderer/TODO.md: "Next
event estimation") it never built. The reference's emissive objects (every
16th index; spheres radiate emission_scale/(4 pi r^2),
sphere_pathtracing.cs.glsl:285-290; meshes use sqrRadius = 1,
triangle_pathtracing.cs.glsl:268) are tiny, so BSDF-only sampling almost
never finds them — NEE samples them explicitly at every diffuse vertex and
casts a shadow ray.

Two samplers, both lane-lockstep (lights are picked with a select-sweep
over the E emissive objects; no per-lane gathers, so the identical code
runs in the oracle and in Pallas kernels):

* AREA sampling (analytic spheres). Uniform point on a uniformly-picked
  light:
    pdf_A = 1 / (E * 4 pi r^2);  Le = scale / (4 pi r^2)
    direct = T * (kd/pi) * Le * cos * cos_L / (d^2 * pdf_A)
           = T * (kd/pi) * scale * E * cos * cos_L / d^2
  (the light's area cancels against its radiance).

* CONE (solid-angle) sampling (triangle meshes). A direction is drawn
  uniformly inside the cone subtended by the picked light's BOUNDING
  sphere and traced with the full nearest-hit sweep; the sample counts iff
  that light is what it hits. Unbiased for arbitrary mesh geometry and
  occlusion — the bound's cone covers every path to the light — without
  touching per-triangle data:
    pdf_w = 1 / (E * Omega),  Omega = 2 pi (1 - cos_max)
    direct = T * (kd/pi) * Le * cos * E * Omega       [iff the light is hit]

Without MIS, emission found by *indirect* BSDF rays is suppressed (each
diffuse vertex already accounts for the lights via NEE; camera-direct hits
keep their emission). With cfg.mis the two strategies are combined with the
balance heuristic instead: any weights that sum to one keep the combination
unbiased, so the (cheap, slightly approximate) cosine-hemisphere pdf is
used for the BSDF side.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from l2n.maths.sampling import PI


@dataclasses.dataclass
class LightSample:
    px: jnp.ndarray   # sampled point on the light surface
    py: jnp.ndarray
    pz: jnp.ndarray
    nx: jnp.ndarray   # light surface normal at the point
    ny: jnp.ndarray
    nz: jnp.ndarray
    index: jnp.ndarray  # scene index of the picked light
    r2: jnp.ndarray     # squared radius of the picked light


def emissive_count(sphere_count: int, emissive_every: int) -> int:
    return (sphere_count + emissive_every - 1) // emissive_every


def make_sphere_light_sampler(sphere_count: int, emissive_every: int, fetch):
    """AREA light sampler over the scene's emissive spheres.

    fetch(i) -> (cx, cy, cz, r2) like the intersection sweeps. Returns
    sample(u_pick, u1, u2) -> LightSample; all inputs are lane arrays in
    (0, 1).
    """
    n_lights = emissive_count(sphere_count, emissive_every)

    def sample(u_pick, u1, u2) -> LightSample:
        f32 = jnp.float32
        pick = jnp.minimum((u_pick * f32(n_lights)).astype(jnp.int32),
                           n_lights - 1)
        shape = jnp.shape(u_pick)
        cx = jnp.zeros(shape, f32)
        cy = jnp.zeros(shape, f32)
        cz = jnp.zeros(shape, f32)
        r = jnp.ones(shape, f32)
        idx = jnp.zeros(shape, jnp.int32)
        # Select-sweep over the E lights (E is small; no per-lane gather).
        for e in range(n_lights):
            scx, scy, scz, sr2 = fetch(e * emissive_every)
            m = pick == e
            cx = jnp.where(m, scx, cx)
            cy = jnp.where(m, scy, cy)
            cz = jnp.where(m, scz, cz)
            r = jnp.where(m, jnp.sqrt(sr2), r)
            idx = jnp.where(m, jnp.int32(e * emissive_every), idx)
        # Uniform point on the sphere surface.
        z = f32(1.0) - f32(2.0) * u1
        s = jnp.sqrt(jnp.maximum(f32(0.0), f32(1.0) - z * z))
        phi = f32(2.0 * PI) * u2
        wx = s * jnp.cos(phi)
        wy = s * jnp.sin(phi)
        return LightSample(px=cx + r * wx, py=cy + r * wy, pz=cz + r * z,
                           nx=wx, ny=wy, nz=z, index=idx, r2=r * r)

    sample.n_lights = n_lights
    sample.kind = "area"
    return sample


def make_mesh_light_sampler(mesh_count: int, emissive_every: int,
                            fetch_bound):
    """CONE light sampler over emissive meshes' bounding spheres.

    fetch_bound(m) -> (cx, cy, cz, r2) of mesh m's bounding sphere (scalar
    components). Returns pick(u_pick) -> (cx, cy, cz, r2, index) lane
    arrays; the direction sampling happens in `nee_cone_contribution` (it
    needs the shading point)."""
    n_lights = emissive_count(mesh_count, emissive_every)

    def pick(u_pick):
        f32 = jnp.float32
        sel = jnp.minimum((u_pick * f32(n_lights)).astype(jnp.int32),
                          n_lights - 1)
        shape = jnp.shape(u_pick)
        cx = jnp.zeros(shape, f32)
        cy = jnp.zeros(shape, f32)
        cz = jnp.zeros(shape, f32)
        r2 = jnp.ones(shape, f32)
        idx = jnp.zeros(shape, jnp.int32)
        for e in range(n_lights):
            bcx, bcy, bcz, br2 = fetch_bound(e * emissive_every)
            m = sel == e
            cx = jnp.where(m, bcx, cx)
            cy = jnp.where(m, bcy, cy)
            cz = jnp.where(m, bcz, cz)
            r2 = jnp.where(m, br2, r2)
            idx = jnp.where(m, jnp.int32(e * emissive_every), idx)
        return cx, cy, cz, r2, idx

    pick.n_lights = n_lights
    pick.kind = "cone"
    return pick


def cone_solid_angle(d2, r2):
    """Omega = 2 pi (1 - cos_max) of a sphere (r2) seen from distance^2 d2;
    the full sphere (4 pi) when the point is inside the bound."""
    f32 = jnp.float32
    inside = d2 <= r2
    cos_max = jnp.sqrt(jnp.maximum(f32(1.0) - r2 / jnp.maximum(d2, f32(1e-20)),
                                   f32(0.0)))
    cos_max = jnp.where(inside, f32(-1.0), cos_max)
    return f32(2.0 * PI) * (f32(1.0) - cos_max), cos_max


def nee_cone_contribution(cfg, sampler, intersect, u_pick, u1, u2,
                          hx, hy, hz, nx, ny, nz, kd_r, kd_g, kd_b,
                          tp_r, tp_g, tp_b, mis: bool = False,
                          brdf_eval=None):
    """Direct light via cone sampling (see module docstring). `intersect`
    is the scene's full nearest-hit sweep — the traced sample doubles as
    the shadow ray. Returns (r, g, b)."""
    from l2n.maths.sampling import frame_z, local_to_world, normalize3

    f32 = jnp.float32
    cx, cy, cz, r2, light_idx = sampler(u_pick)
    wx, wy, wz = cx - hx, cy - hy, cz - hz
    d2 = wx * wx + wy * wy + wz * wz
    omega, cos_max = cone_solid_angle(d2, r2)
    ax, ay, az = normalize3(wx, wy, wz)

    cos_t = f32(1.0) - u1 * (f32(1.0) - cos_max)
    sin_t = jnp.sqrt(jnp.maximum(f32(1.0) - cos_t * cos_t, f32(0.0)))
    phi = f32(2.0 * PI) * u2
    tangent, bitangent = frame_z(ax, ay, az)
    lx, ly, lz = local_to_world(sin_t * jnp.cos(phi), sin_t * jnp.sin(phi),
                                cos_t, tangent, bitangent, (ax, ay, az))

    sh = intersect(hx + f32(cfg.ray_epsilon) * lx,
                   hy + f32(cfg.ray_epsilon) * ly,
                   hz + f32(cfg.ray_epsilon) * lz, lx, ly, lz)
    lit = (sh.t >= 0.0) & (sh.index == light_idx)
    transmit = None
    if cfg.fog_density > 0.0:
        # Homogeneous medium: the shadow segment's transmittance is the
        # analytic Beer-Lambert factor over the traced distance to the
        # light (no collision sampling needed on shadow rays).
        transmit = jnp.exp(f32(-cfg.fog_density) * jnp.maximum(sh.t, f32(0.0)))

    nhx, nhy, nhz = normalize3(nx, ny, nz)
    cos_s = jnp.maximum(nhx * lx + nhy * ly + nhz * lz, f32(0.0))
    if brdf_eval is None:
        f_r = kd_r * f32(1.0 / PI)
        f_g = kd_g * f32(1.0 / PI)
        f_b = kd_b * f32(1.0 / PI)
        p_bsdf = cos_s * f32(1.0 / PI)
    else:
        f_r, f_g, f_b, p_bsdf = brdf_eval(lx, ly, lz)
    # Le = scale/(4 pi * 1): meshes emit with sqrRadius = 1 (glsl:268).
    le = f32(cfg.emission_scale / (4.0 * PI))
    w = cos_s * le * f32(sampler.n_lights) * omega
    if mis:
        p_nee = f32(1.0) / jnp.maximum(f32(sampler.n_lights) * omega,
                                       f32(1e-20))
        w = w * p_nee / jnp.maximum(p_nee + p_bsdf, f32(1e-20))
    if transmit is not None:
        w = w * transmit
    w = jnp.where(lit, w, f32(0.0))
    return tp_r * f_r * w, tp_g * f_g * w, tp_b * f_b * w


def mis_emission_weight(cfg, kind: str, n_lights: int, prev_pdf,
                        bdx, bdy, bdz, cur_t, nx, ny, nz, emis_r2, bound_r2):
    """Balance-heuristic weight for emission found by a BSDF ray: the pdf
    with which NEE *would* have produced this direction from the previous
    vertex, against the BSDF pdf that did.

    prev_pdf: the BSDF sampling pdf of the ray (cos/pi). kind matches the
    scene's NEE strategy ("area" over the light's surface converted to
    solid angle; "cone" over its bounding sphere)."""
    f32 = jnp.float32
    if kind == "area":
        # p_nee(omega) = d^2 / (A cos_L) / E, A = 4 pi r^2.
        from l2n.maths.sampling import normalize3
        nhx, nhy, nhz = normalize3(nx, ny, nz)
        cos_l = jnp.maximum(-(nhx * bdx + nhy * bdy + nhz * bdz), f32(0.0))
        d2 = cur_t * cur_t
        area = f32(4.0 * PI) * jnp.maximum(emis_r2, f32(1e-20))
        p_nee = d2 / jnp.maximum(area * cos_l * f32(n_lights), f32(1e-20))
    else:
        # p_nee(omega) = 1 / (E * Omega(prev vertex, light bound)). The
        # light's bound center is recovered exactly from the hit: for
        # sphere-radial meshes normal*r == hit - center.
        r = jnp.sqrt(jnp.maximum(bound_r2, f32(1e-20)))
        # distance^2 from the previous vertex to the light center: the ray
        # travelled cur_t to the hit; center = hit - n*r; hit - origin =
        # cur_t * dir.
        vx = cur_t * bdx - nx * r
        vy = cur_t * bdy - ny * r
        vz = cur_t * bdz - nz * r
        d2 = vx * vx + vy * vy + vz * vz
        omega, _ = cone_solid_angle(d2, bound_r2)
        p_nee = f32(1.0) / jnp.maximum(f32(n_lights) * omega, f32(1e-20))
    return prev_pdf / jnp.maximum(prev_pdf + p_nee, f32(1e-20))


def nee_contribution(cfg, n_lights: int, intersect, light: LightSample,
                     hx, hy, hz, nx, ny, nz, kd_r, kd_g, kd_b,
                     tp_r, tp_g, tp_b, mis: bool = False, brdf_eval=None):
    """Direct-light radiance for diffuse vertices at (h, n) with albedo kd
    and path throughput tp. Returns (r, g, b) — zero where shadowed or
    back-facing.

    `brdf_eval(lx, ly, lz) -> (f_r, f_g, f_b, pdf_bsdf)` overrides the
    Lambert kd/pi (microfacet material mode)."""
    f32 = jnp.float32
    lx = light.px - hx
    ly = light.py - hy
    lz = light.pz - hz
    d2 = lx * lx + ly * ly + lz * lz
    dist = jnp.sqrt(jnp.maximum(d2, f32(1e-20)))
    rcp = jax.lax.rsqrt(jnp.maximum(d2, f32(1e-20)))  # = 1/dist, as XLA has it
    lx, ly, lz = lx * rcp, ly * rcp, lz * rcp
    cos_s = jnp.maximum(nx * lx + ny * ly + nz * lz, f32(0.0))
    cos_l = jnp.maximum(-(light.nx * lx + light.ny * ly + light.nz * lz),
                        f32(0.0))
    # Shadow ray: visible iff the picked light is the first thing hit.
    sh = intersect(hx + f32(cfg.ray_epsilon) * lx,
                   hy + f32(cfg.ray_epsilon) * ly,
                   hz + f32(cfg.ray_epsilon) * lz, lx, ly, lz)
    visible = sh.index == light.index
    if brdf_eval is None:
        f_r = kd_r * f32(1.0 / PI)
        f_g = kd_g * f32(1.0 / PI)
        f_b = kd_b * f32(1.0 / PI)
        p_bsdf = cos_s * f32(1.0 / PI)
    else:
        f_r, f_g, f_b, p_bsdf = brdf_eval(lx, ly, lz)
    # Le * cos * cos_L * E * A / (d^2 * A) — the light's area cancels
    # against its radiance (Le = scale / A).
    scale = (f32(cfg.emission_scale * n_lights) * cos_s * cos_l
             / jnp.maximum(d2, f32(1e-20)))
    if mis:
        # Balance heuristic vs the BSDF strategy (any weights summing to 1
        # keep the combination unbiased; see module docstring).
        area = f32(4.0 * PI) * jnp.maximum(light.r2, f32(1e-20))
        p_nee = d2 / jnp.maximum(area * cos_l * f32(n_lights), f32(1e-20))
        scale = scale * p_nee / jnp.maximum(p_nee + p_bsdf, f32(1e-20))
    if cfg.fog_density > 0.0:
        # Homogeneous medium: analytic Beer-Lambert transmittance over the
        # vertex -> light-point distance (fog never blocks a shadow ray
        # stochastically; the exponential factor is exact).
        scale = scale * jnp.exp(f32(-cfg.fog_density) * dist)
    w = jnp.where(visible, scale, f32(0.0))
    return (tp_r * f_r * w, tp_g * f_g * w, tp_b * f_b * w)
