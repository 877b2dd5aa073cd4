"""The path tracer: ray generation, the masked bounce loop, AOV channels.

Lane-lockstep rewrite of the reference's divergent per-thread `pathtracing`
(l2n-renderer/src/shaders/sphere_pathtracing.cs.glsl:272-317 and the
isomorphic triangle variant triangle_pathtracing.cs.glsl:250-299): the
`while (dist >= 0 && pathLength <= 1)` loop becomes a fixed-depth unrolled
loop over `max_bounces` with per-lane masks; Russian roulette and emissive
termination become mask updates. The reference's tri-state `dist` sentinel
is preserved exactly (t >= 0 hit, -1 miss -> environment, -2 terminated)
because the env test is literally `dist == -1.0` (glsl:313).

Everything operates on arbitrary-shaped lane arrays in SoA component form;
scene access is through an `intersect(ox,oy,oz,dx,dy,dz) -> Hit` closure so
the identical code serves the sphere scene, the triangle scene, the pure-XLA
oracle, and the Pallas kernel body.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp

from l2n.camera.camera import ROW_POSITION, ROW_PROJ, ROW_RCP_VIEW, ROW_RCP_VIEW_PROJ
from l2n.maths.sampling import (
    PI,
    cosine_sample_hemisphere,
    frame_z,
    local_to_world,
    luminance,
    normalize3,
    procedural_color,
)
from l2n.ops.envlight import any_lane, env_radiance


@dataclasses.dataclass
class Hit:
    """Resolved hit record (lane arrays).

    `index` is the shading index (sphere index / mesh index; -1 on miss) fed
    to the procedural albedo and the emissive test; `emis_r2` the squared
    radius in the emission formula (the sphere's own, glsl:286; constant 1
    for triangle meshes, triangle_pathtracing.cs.glsl:268). `tc_u/tc_v`
    (texcoords) and `b_u/b_v` (barycentrics) are zero for scenes without
    them.
    """

    t: jnp.ndarray
    px: jnp.ndarray
    py: jnp.ndarray
    pz: jnp.ndarray
    nx: jnp.ndarray
    ny: jnp.ndarray
    nz: jnp.ndarray
    index: jnp.ndarray
    emis_r2: jnp.ndarray
    tc_u: jnp.ndarray | None = None
    tc_v: jnp.ndarray | None = None
    b_u: jnp.ndarray | None = None
    b_v: jnp.ndarray | None = None
    # Squared radius of the winning object's BOUNDING sphere (triangle
    # scenes; feeds the cone-NEE MIS weight). None where not applicable.
    bound_r2: jnp.ndarray | None = None


IntersectFn = Callable[..., Hit]  # (ox, oy, oz, dx, dy, dz) -> Hit


# ---------------------------------------------------------------------------
# Ray generation
# ---------------------------------------------------------------------------

def generate_rays(cfg, cam, px, py, u1, u2):
    """Jittered primary rays for float pixel coords (px, py).

    `cam` is anything indexable as the packed (10, 4) camera block (a jnp
    array in the oracle, a Pallas ref inside the kernel).

    Two variants, both from the reference:
      * "fovy" (the GPU kernel, sphere_pathtracing.cs.glsl:371-384): scale
        NDC by (ratio*tanHalfFovy, tanHalfFovy, -1, 1) — "equivalent to
        multiplication by the inverse perspective matrix, but better
        numerical precision" (glsl:380) — then apply the inverse view.
      * "viewproj" (the CPU renderer, src/main.cpp:562-567): full inverse
        view-projection with perspective divide, NDC z on the far plane.

    Returns (ox, oy, oz, dx, dy, dz).
    """
    f32 = jnp.float32
    sx = (px + u1) * f32(1.0 / (cfg.ndc_width or cfg.width))
    sy = (py + u2) * f32(1.0 / (cfg.ndc_height or cfg.height))
    ndx = f32(-1.0) + f32(2.0) * sx
    ndy = f32(-1.0) + f32(2.0) * sy

    pos_x, pos_y, pos_z = (cam[ROW_POSITION, 0], cam[ROW_POSITION, 1],
                           cam[ROW_POSITION, 2])

    if cfg.ray_gen == "fovy":
        ratio = cam[ROW_PROJ, 0]
        tan_half = cam[ROW_PROJ, 1]
        vx = ndx * ratio * tan_half
        vy = ndy * tan_half
        vz = f32(-1.0)
        r = ROW_RCP_VIEW
        wx = cam[r + 0, 0] * vx + cam[r + 0, 1] * vy + cam[r + 0, 2] * vz + cam[r + 0, 3]
        wy = cam[r + 1, 0] * vx + cam[r + 1, 1] * vy + cam[r + 1, 2] * vz + cam[r + 1, 3]
        wz = cam[r + 2, 0] * vx + cam[r + 2, 1] * vy + cam[r + 2, 2] * vz + cam[r + 2, 3]
    elif cfg.ray_gen == "viewproj":
        vz = f32(1.0)
        r = ROW_RCP_VIEW_PROJ
        wx = cam[r + 0, 0] * ndx + cam[r + 0, 1] * ndy + cam[r + 0, 2] * vz + cam[r + 0, 3]
        wy = cam[r + 1, 0] * ndx + cam[r + 1, 1] * ndy + cam[r + 1, 2] * vz + cam[r + 1, 3]
        wz = cam[r + 2, 0] * ndx + cam[r + 2, 1] * ndy + cam[r + 2, 2] * vz + cam[r + 2, 3]
        ww = cam[r + 3, 0] * ndx + cam[r + 3, 1] * ndy + cam[r + 3, 2] * vz + cam[r + 3, 3]
        rcp_w = f32(1.0) / ww
        wx, wy, wz = wx * rcp_w, wy * rcp_w, wz * rcp_w
    else:  # pragma: no cover - validated in config
        raise ValueError(f"unknown ray_gen {cfg.ray_gen!r}")

    dx, dy, dz = normalize3(wx - pos_x, wy - pos_y, wz - pos_z)
    # The origin stays SCALAR (all primary rays share the camera position,
    # glsl:384): downstream per-sphere terms involving only the origin then
    # fold to scalars in the primary intersection sweep. Everything broadcasts on demand.
    return pos_x, pos_y, pos_z, dx, dy, dz


# ---------------------------------------------------------------------------
# Path tracing (the "pathtracing" render mode)
# ---------------------------------------------------------------------------

def _env_term(cfg, edx, edy, edz):
    """Environment radiance for a miss direction (glsl:312-314)."""
    return (env_radiance(cfg.env_mode, edx, edy, edz)
            * jnp.float32(cfg.env_scale))


def _emit_term(cfg, emis_r2):
    """scale / (4 pi r^2) (glsl:288), guarded where r2 is meaningless."""
    f32 = jnp.float32
    return f32(cfg.emission_scale) / (f32(4.0 * PI)
                                      * jnp.maximum(emis_r2, f32(1e-20)))


def _fog_sigma(cfg):
    return float(cfg.fog_density)


def _fog_sky(cfg):
    return float(cfg.fog_sky_distance or 4.0 * cfg.world_size)


def _fog_collision(cfg, sampler, mask, hit_t):
    """Collision (distance) sampling for the homogeneous medium: draw
    t_fog ~ Exp(fog_density) and compare against the segment's surface hit
    (or the finite sky distance on a miss). Returns (medium, t_fog):
    medium lanes scatter in the volume before reaching anything. The draw
    happens in lockstep on every call so the counter-based stream layout
    is static; `mask` tags the lanes that semantically consume it."""
    f32 = jnp.float32
    u = sampler.draw1(mask=mask)
    # u in (0, 1) open-open: log(u) is finite; t_fog in (0, inf).
    t_fog = -jnp.log(u) * f32(1.0 / _fog_sigma(cfg))
    t_lim = jnp.where(hit_t >= 0.0, hit_t, f32(_fog_sky(cfg)))
    return mask & (t_fog < t_lim), t_fog


def _resolve_vertex(cfg, light_sampler, use_nee, use_mis, dist,
                    bdx, bdy, bdz, cur_t, nx, ny, nz, index, emis_r2,
                    bound_r2, tp_r, tp_g, tp_b, col_r, col_g, col_b,
                    prev_pdf, emission_ok):
    """Emissive resolve at a bounce vertex (loop iterations b >= 1):
    emissive lanes add their weighted radiance and terminate
    (glsl:285-290). Returns (dist', diffuse, col_r', col_g', col_b')."""
    f32 = jnp.float32
    active = dist >= 0.0  # while (dist >= 0.0 ...), glsl:280
    emissive = active & (index % cfg.emissive_every == 0)
    diffuse = active & ~emissive
    emit = _emit_term(cfg, emis_r2)
    if use_mis:
        # BSDF-found emission weighted against the NEE pdf of the same
        # direction (every lane here arrived via a BSDF-sampled bounce,
        # so prev_pdf is its pdf).
        from l2n.ops.nee import mis_emission_weight
        w = mis_emission_weight(
            cfg, light_sampler.kind, light_sampler.n_lights,
            prev_pdf, bdx, bdy, bdz, cur_t, nx, ny, nz, emis_r2, bound_r2)
        if cfg.fog_density > 0.0:
            # Rays scattered at a FOG-COLLISION vertex had no NEE
            # competitor (fog vertices take no NEE, _scatter_and_roulette):
            # the NEE strategy's pdf is zero there and their emission
            # keeps FULL weight. emission_ok == 2 marks those lanes.
            w = jnp.where(emission_ok == 2, f32(1.0), w)
        emit = emit * w
        add_em = emissive
    elif use_nee:
        add_em = emissive & (emission_ok == 1)
    else:
        add_em = emissive
    col_r = jnp.where(add_em, col_r + tp_r * emit, col_r)
    col_g = jnp.where(add_em, col_g + tp_g * emit, col_g)
    col_b = jnp.where(add_em, col_b + tp_b * emit, col_b)
    dist = jnp.where(emissive, f32(-2.0), dist)
    return dist, diffuse, col_r, col_g, col_b


def _scatter_and_roulette(cfg, intersect, sampler, light_sampler, use_nee,
                          use_mis, b, box, boy, boz, bdx, bdy, bdz, cur_t,
                          nx, ny, nz, index, diffuse, tp_r, tp_g, tp_b,
                          col_r, col_g, col_b, prev_pdf, emission_ok,
                          stats=None, medium=None, lights=None):
    """The per-vertex block of the tracer: BSDF sample (procedural Lambert, glsl:292-300, or the
    microfacet wishlist lobe), optional NEE, throughput update, Russian
    roulette (glsl:302-309), continuation-ray origin (far-parked for dead
    lanes so downstream bound tests NaN-poison, see trace_path).

    `medium` marks lanes whose vertex is a FOG COLLISION rather than a
    surface (cfg.fog_density > 0; the caller merged t_fog into cur_t and a
    non-emissive sentinel into index): they scatter isotropically from the
    same two hemisphere draws and their weight is fog_albedo instead of
    the surface BSDF.

    Returns (box, boy, boz, bdx, bdy, bdz, tp_r, tp_g, tp_b, col_r, col_g,
    col_b, prev_pdf, emission_ok, survive, cast_ox, cast_oy, cast_oz)."""
    f32 = jnp.float32
    hx = box + cur_t * bdx
    hy = boy + cur_t * bdy
    hz = boz + cur_t * bdz
    kd_r, kd_g, kd_b = procedural_color(index)
    if lights is not None and lights.albedo.shape[0]:
        # Live PhongMaterials (ops/lights.py): per-object diffuse override
        # of the procedural hash, one site covering oracle + kernels.
        kd_r, kd_g, kd_b = lights.override_albedo(index, kd_r, kd_g, kd_b)
    want_eval = use_nee or (lights is not None and lights.has_lights)
    if cfg.normal_map > 0.0:
        # Normal mapping (wishlist TODO.md:5): perturb the SHADING normal
        # before any BSDF frame / NEE cosine sees it. One insertion point
        # covers the oracle and the kernel (both trace this block). Fog-collision lanes never read normals (their direction
        # is overwritten by the phase-function draw below).
        from l2n.maths.bump import perturb_normal
        nx, ny, nz = perturb_normal(cfg, index, hx, hy, hz, nx, ny, nz)
    brdf_eval = None
    if cfg.material_mode in ("microfacet", "disney"):
        from l2n.maths.brdf import (
            eval_brdf,
            eval_disney,
            procedural_disney_params,
            procedural_roughness,
            sample_brdf,
            sample_disney,
        )
        nhx, nhy, nhz = normalize3(nx, ny, nz)
        tangent, bitangent = frame_z(nhx, nhy, nhz)
        rough = procedural_roughness(index)
        wox, woy, woz = -bdx, -bdy, -bdz
        u1, u2 = sampler.draw2(mask=diffuse)
        u_lobe = sampler.draw1(mask=diffuse)
        if cfg.material_mode == "disney":
            metal, spec, sheen, subsurf = procedural_disney_params(index)
            (wdx, wdy, wdz, w_r, w_g, w_b, pdf_b) = sample_disney(
                u_lobe, u1, u2, nhx, nhy, nhz, tangent, bitangent,
                wox, woy, woz, kd_r, kd_g, kd_b, rough, metal, spec, sheen,
                subsurf)
            if want_eval:
                def brdf_eval(lx, ly, lz, _n=(nhx, nhy, nhz),
                              _wo=(wox, woy, woz),
                              _kd=(kd_r, kd_g, kd_b), _ro=rough,
                              _ds=(metal, spec, sheen, subsurf)):
                    return eval_disney(_n[0], _n[1], _n[2],
                                       _wo[0], _wo[1], _wo[2],
                                       lx, ly, lz,
                                       _kd[0], _kd[1], _kd[2], _ro,
                                       _ds[0], _ds[1], _ds[2], _ds[3])
        else:
            (wdx, wdy, wdz, w_r, w_g, w_b, pdf_b) = sample_brdf(
                u_lobe, u1, u2, nhx, nhy, nhz, tangent, bitangent,
                wox, woy, woz, kd_r, kd_g, kd_b, rough)
            if want_eval:
                def brdf_eval(lx, ly, lz, _n=(nhx, nhy, nhz),
                              _wo=(wox, woy, woz),
                              _kd=(kd_r, kd_g, kd_b), _ro=rough):
                    return eval_brdf(_n[0], _n[1], _n[2],
                                     _wo[0], _wo[1], _wo[2],
                                     lx, ly, lz,
                                     _kd[0], _kd[1], _kd[2], _ro)
        if use_mis:
            prev_pdf = jnp.where(diffuse, pdf_b, prev_pdf)
    else:
        tangent, bitangent = frame_z(nx, ny, nz)
        u1, u2 = sampler.draw2(mask=diffuse)
        (lx, ly, lz), _ = cosine_sample_hemisphere(u1, u2)
        wdx, wdy, wdz = local_to_world(lx, ly, lz, tangent,
                                       bitangent, (nx, ny, nz))
        wdx, wdy, wdz = normalize3(wdx, wdy, wdz)
        w_r, w_g, w_b = kd_r, kd_g, kd_b
        if use_mis:
            # Cosine-hemisphere pdf of the sampled direction (lz is the
            # local cos theta); approximate under the reference's
            # unnormalized frame, which only redistributes MIS weight.
            prev_pdf = jnp.where(diffuse, lz * f32(1.0 / PI), prev_pdf)

    if medium is not None:
        # Isotropic phase function from the same (u1, u2): z uniform in
        # (-1, 1), azimuth 2*pi*u2; collision estimator weight = single-
        # scattering albedo (sigma_s / sigma_t).
        mz = f32(1.0) - f32(2.0) * u1
        ms = jnp.sqrt(jnp.maximum(f32(1.0) - mz * mz, f32(0.0)))
        mphi = f32(2.0 * PI) * u2
        wdx = jnp.where(medium, ms * jnp.cos(mphi), wdx)
        wdy = jnp.where(medium, ms * jnp.sin(mphi), wdy)
        wdz = jnp.where(medium, mz, wdz)
        alb = f32(cfg.fog_albedo)
        w_r = jnp.where(medium, alb, w_r)
        w_g = jnp.where(medium, alb, w_g)
        w_b = jnp.where(medium, alb, w_b)

    if use_nee:
        # Direct light sampling at this diffuse vertex (uses the
        # pre-multiplication throughput and the vertex albedo).
        # MIS-weighted except on the LAST iteration, whose BSDF side can
        # never collect its emission (the loop truncates, mirroring the
        # reference's pathLength cap) — NEE keeps full weight there so no
        # energy is lost.
        #
        # FOG-COLLISION vertices take no NEE (their phase function is not
        # the surface BSDF the estimators evaluate); they keep emission_ok
        # so their scattered rays can still find lights by BSDF sampling —
        # no double counting, no lost energy. Surface vertices under fog
        # get the analytic exp(-sigma*d) shadow transmittance inside the
        # contribution functions (nee.py).
        surface = diffuse if medium is None else (diffuse & ~medium)
        mis_here = use_mis and (b + 1 < cfg.max_bounces)
        u_pick = sampler.draw1(mask=diffuse)
        ul1, ul2 = sampler.draw2(mask=diffuse)
        if light_sampler.kind == "area":
            from l2n.ops.nee import nee_contribution
            light = light_sampler(u_pick, ul1, ul2)
            dr, dg, db = nee_contribution(
                cfg, light_sampler.n_lights, intersect, light,
                hx, hy, hz, nx, ny, nz, kd_r, kd_g, kd_b,
                tp_r, tp_g, tp_b, mis=mis_here,
                brdf_eval=brdf_eval)
        else:
            from l2n.ops.nee import nee_cone_contribution
            dr, dg, db = nee_cone_contribution(
                cfg, light_sampler, intersect, u_pick, ul1, ul2,
                hx, hy, hz, nx, ny, nz, kd_r, kd_g, kd_b,
                tp_r, tp_g, tp_b, mis=mis_here,
                brdf_eval=brdf_eval)
        col_r = jnp.where(surface, col_r + dr, col_r)
        col_g = jnp.where(surface, col_g + dg, col_g)
        col_b = jnp.where(surface, col_b + db, col_b)
        if not use_mis:
            emission_ok = jnp.where(surface, 0, emission_ok)
            if medium is not None:
                # A fog vertex did NOT do NEE, so its scattered ray must be
                # allowed to collect emission even if an earlier surface
                # vertex had closed it — otherwise surface->fog->light
                # paths would be counted by neither strategy.
                emission_ok = jnp.where(diffuse & medium, 1, emission_ok)
        elif medium is not None:
            # MIS under fog: the plane becomes a per-lane weight selector
            # for the next emission resolve (1 = balance weight, 2 = full
            # weight). Fog vertices take no NEE, so the NEE strategy has
            # pdf ZERO for their scattered rays — the balance weight must
            # not divide their emission against a competitor that never
            # existed (_resolve_vertex forces weight 1 where == 2).
            emission_ok = jnp.where(
                diffuse, jnp.where(medium, 2, 1), emission_ok)

    if lights is not None and lights.has_lights:
        # Explicit (Dirac) point/directional lights — the reference's
        # declared-but-dead light buffers made live (ops/lights.py). No
        # sampler draws, no MIS interaction; surface vertices only (the
        # isotropic phase estimator is not the f the term evaluates).
        from l2n.ops.lights import explicit_light_contribution
        surface = diffuse if medium is None else (diffuse & ~medium)
        er, eg, eb = explicit_light_contribution(
            cfg, lights, intersect, hx, hy, hz, nx, ny, nz,
            kd_r, kd_g, kd_b, tp_r, tp_g, tp_b, brdf_eval=brdf_eval)
        col_r = jnp.where(surface, col_r + er, col_r)
        col_g = jnp.where(surface, col_g + eg, col_g)
        col_b = jnp.where(surface, col_b + eb, col_b)

    box = jnp.where(diffuse, hx, box)
    boy = jnp.where(diffuse, hy, boy)
    boz = jnp.where(diffuse, hz, boz)
    bdx = jnp.where(diffuse, wdx, bdx)
    bdy = jnp.where(diffuse, wdy, bdy)
    bdz = jnp.where(diffuse, wdz, bdz)
    tp_r = jnp.where(diffuse, tp_r * w_r, tp_r)
    tp_g = jnp.where(diffuse, tp_g * w_g, tp_g)
    tp_b = jnp.where(diffuse, tp_b * w_b, tp_b)

    # Russian roulette (glsl:302-309): survive with p = min(ceiling,
    # luminance(throughput)); survivors get throughput / p.
    rr = sampler.draw1(mask=diffuse)
    rr_prob = jnp.minimum(f32(cfg.rr_ceiling),
                          luminance(tp_r, tp_g, tp_b))
    survive = diffuse & (rr < rr_prob)
    rcp_p = f32(1.0) / jnp.maximum(rr_prob, f32(1e-20))
    tp_r = jnp.where(survive, tp_r * rcp_p, tp_r)
    tp_g = jnp.where(survive, tp_g * rcp_p, tp_g)
    tp_b = jnp.where(survive, tp_b * rcp_p, tp_b)

    if stats is not None:
        # Physical ray-segment accounting for throughput metrics:
        # survivors cast one more scene ray (the primary is always 1).
        stats.setdefault("survive_fraction", []).append(
            jnp.mean(survive.astype(f32)))
    # Continuation ray from org + eps*dir (glsl:305). Lockstep: computed
    # for every lane, merged into survivors. Dead lanes cast from a
    # far-away origin so block-level culls (mesh bounds) are not kept
    # alive by results nobody will merge; 3e30 overflows squared-distance
    # terms, NaN-poisoning those lanes' tests outright.
    far = f32(3.0e30)
    cast_ox = jnp.where(survive, box + f32(cfg.ray_epsilon) * bdx, far)
    cast_oy = jnp.where(survive, boy + f32(cfg.ray_epsilon) * bdy, far)
    cast_oz = jnp.where(survive, boz + f32(cfg.ray_epsilon) * bdz, far)
    return (box, boy, boz, bdx, bdy, bdz, tp_r, tp_g, tp_b,
            col_r, col_g, col_b, prev_pdf, emission_ok, survive,
            cast_ox, cast_oy, cast_oz)


def _hit_bound_r2(h: Hit):
    return h.bound_r2 if h.bound_r2 is not None else h.emis_r2


def _finish_path(cfg, intersect, sampler, start_b, entered, pending, dist,
                 cast_ox, cast_oy, cast_oz, bdx, bdy, bdz,
                 tp_r, tp_g, tp_b, col_r, col_g, col_b,
                 prev_pdf, emission_ok,
                 intersect_anyhit=None,
                 light_sampler=None, use_nee=False, use_mis=False,
                 stats=None, lights=None):
    """Finish a path from a PENDING cast ray issued at iteration start_b - 1:
    intersect it, then run iterations start_b .. max_bounces-1 and the final
    environment resolve (glsl:312-314).

    `pending` marks lanes whose cast is live (others keep their `dist`
    sentinel); `entered` marks lanes that were diffuse at the primary vertex
    (the env gate — primary misses resolved their sky before the bounce
    region, see trace_path).

    Winner state from a cast (normals/index/emis_r2) is deliberately NOT
    merged over non-surviving lanes: every consumer is gated by masks derived
    from `dist`, which IS merged — resolved lanes can observe garbage values
    but never keep them.
    """
    f32 = jnp.float32

    def env_add(col_r, col_g, col_b, dist, edx, edy, edz):
        if cfg.env_mode == "none":
            return col_r, col_g, col_b
        env_ok = entered & (dist == f32(-1.0))
        le = _env_term(cfg, edx, edy, edz)
        return (jnp.where(env_ok, col_r + tp_r * le, col_r),
                jnp.where(env_ok, col_g + tp_g * le, col_g),
                jnp.where(env_ok, col_b + tp_b * le, col_b))

    def final_anyhit(cast_ox, cast_oy, cast_oz, bdx, bdy, bdz):
        if intersect_anyhit is not None:
            return intersect_anyhit(cast_ox, cast_oy, cast_oz,
                                    bdx, bdy, bdz)
        return None

    if start_b >= cfg.max_bounces:
        # The pending cast is the path's FINAL segment: its nearest hit is
        # only ever compared with the miss sentinel (glsl:312-314), so a
        # boolean any-hit resolve suffices.
        hit_any = final_anyhit(cast_ox, cast_oy, cast_oz, bdx, bdy, bdz)
        if hit_any is None:
            hit_any = intersect(cast_ox, cast_oy, cast_oz,
                                bdx, bdy, bdz).t >= 0.0
        if cfg.fog_density > 0.0:
            fmed, _ = _fog_collision(
                cfg, sampler, pending,
                jnp.where(hit_any, f32(0.0), f32(-1.0)))
            hit_any = hit_any | fmed
        dist = jnp.where(pending,
                         jnp.where(hit_any, f32(1.0), f32(-1.0)), dist)
        return env_add(col_r, col_g, col_b, dist, bdx, bdy, bdz)

    fog = cfg.fog_density > 0.0
    new = intersect(cast_ox, cast_oy, cast_oz, bdx, bdy, bdz)
    box, boy, boz = cast_ox, cast_oy, cast_oz
    cur_t, nx, ny, nz = new.t, new.nx, new.ny, new.nz
    index, emis_r2, bound_r2 = new.index, new.emis_r2, _hit_bound_r2(new)
    if fog:
        medium, t_fog = _fog_collision(cfg, sampler, pending, new.t)
        cur_t = jnp.where(medium, t_fog, cur_t)
        # Non-emissive sentinel: a fog collision is never a light.
        index = jnp.where(medium, jnp.int32(1), index)
        dist = jnp.where(pending, jnp.where(medium, t_fog, new.t), dist)
    else:
        medium = None
        dist = jnp.where(pending, new.t, dist)
    for b in range(start_b, cfg.max_bounces):
        # Resolve this iteration's incoming hit: emissive lanes add their
        # weighted radiance and terminate (glsl:285-290).
        dist, diffuse, col_r, col_g, col_b = _resolve_vertex(
            cfg, light_sampler, use_nee, use_mis, dist,
            bdx, bdy, bdz, cur_t, nx, ny, nz, index, emis_r2,
            bound_r2, tp_r, tp_g, tp_b, col_r, col_g, col_b,
            prev_pdf, emission_ok)
        (box, boy, boz, bdx, bdy, bdz, tp_r, tp_g, tp_b,
         col_r, col_g, col_b, prev_pdf, emission_ok, survive,
         cast_ox, cast_oy, cast_oz) = _scatter_and_roulette(
            cfg, intersect, sampler, light_sampler, use_nee, use_mis,
            b, box, boy, boz, bdx, bdy, bdz, cur_t, nx, ny, nz, index,
            diffuse, tp_r, tp_g, tp_b, col_r, col_g, col_b, prev_pdf,
            emission_ok, stats=stats, medium=medium, lights=lights)
        dist = jnp.where(diffuse & ~survive, f32(-2.0), dist)
        if b + 1 == cfg.max_bounces and intersect_anyhit is not None:
            hit_any = final_anyhit(cast_ox, cast_oy, cast_oz, bdx, bdy, bdz)
            if fog:
                # A fog collision on the FINAL segment truncates the path
                # (like the reference's length cap); the sky needs both a
                # surface miss and a collision-free flight to the sky
                # shell.
                fmed, t_fog = _fog_collision(
                    cfg, sampler, survive,
                    jnp.where(hit_any, f32(0.0), f32(-1.0)))
                hit_any = hit_any | fmed
            dist = jnp.where(survive,
                             jnp.where(hit_any, f32(1.0), f32(-1.0)), dist)
        else:
            new = intersect(cast_ox, cast_oy, cast_oz, bdx, bdy, bdz)
            cur_t, nx, ny, nz = new.t, new.nx, new.ny, new.nz
            index, emis_r2 = new.index, new.emis_r2
            bound_r2 = _hit_bound_r2(new)
            if fog:
                medium, t_fog = _fog_collision(cfg, sampler, survive, new.t)
                cur_t = jnp.where(medium, t_fog, cur_t)
                index = jnp.where(medium, jnp.int32(1), index)
                dist = jnp.where(survive,
                                 jnp.where(medium, t_fog, new.t), dist)
            else:
                dist = jnp.where(survive, new.t, dist)

    return env_add(col_r, col_g, col_b, dist, bdx, bdy, bdz)


def trace_path(cfg, intersect: IntersectFn, sampler, ox, oy, oz, dx, dy, dz,
               skip_empty: bool = False, stats: dict | None = None,
               intersect_primary: IntersectFn | None = None,
               intersect_anyhit=None, light_sampler=None, lights=None):
    """Trace one sample per lane; returns (r, g, b).

    Exact mask translation of sphere_pathtracing.cs.glsl:272-317 — see the
    inline references. Every lane executes every bounce's arithmetic;
    masks decide what is kept.

    Radiance is ACCUMULATED THE MOMENT A LANE RESOLVES — emissive hits when
    they terminate (glsl:286-290), the environment when a cast misses
    (dist == -1; the reference adds it after the loop, glsl:312-314, but a
    resolved lane's throughput/direction never change again, so adding at
    miss time is algebraically identical). This keeps the whole bounce
    machinery's state LOCAL to the bounce region: only the three color sums
    cross out of it, which is what keeps the `skip_empty` branch cheap.

    `skip_empty=True` wraps the bounce loop in one `lax.cond(any(diffuse))`
    so a lane block with no surviving paths skips every scene sweep — the
    block-level form of the reference's early SIMT `while` exit
    (glsl:280), profitable inside the kernel (sky blocks die after the
    primary cast).
    Only valid with stateless samplers: skipping must not desynchronize
    per-pixel RNG streams, so it is disabled for stateful parity modes.
    """
    f32 = jnp.float32
    shape = jnp.shape(dx)
    use_nee = cfg.nee and light_sampler is not None
    use_mis = use_nee and cfg.mis
    use_cond = skip_empty and not getattr(sampler, "stateful", False)

    # The primary cast may use a specialized sweep (constant origin, tile
    # cone culling); bounce casts see arbitrary rays and use the full one.
    hit = (intersect_primary or intersect)(ox, oy, oz, dx, dy, dz)
    ox = jnp.broadcast_to(ox, shape)
    oy = jnp.broadcast_to(oy, shape)
    oz = jnp.broadcast_to(oz, shape)

    # Resolve the direct emissive hits up front with throughput = 1
    # (glsl:285-290). The ENVIRONMENT — primary-miss sky and bounce-miss
    # alike — is evaluated at a single site per sample inside _finish_path:
    # a primary-miss lane flows through the bounce region untouched (its
    # direction is never re-scattered, its throughput stays 1, its dist
    # stays -1), so one evaluation on the final directions covers both
    # cases bit-exactly while halving the Mandelbrot cost.
    fog = cfg.fog_density > 0.0
    p_cur_t, p_index = hit.t, hit.index
    if fog:
        everyone = jnp.ones(shape, bool)
        p_medium, p_tfog = _fog_collision(cfg, sampler, everyone, hit.t)
        p_cur_t = jnp.where(p_medium, p_tfog, hit.t)
        p_index = jnp.where(p_medium, jnp.int32(1), hit.index)
    else:
        p_medium = None
    p_active = (hit.t >= 0.0) if not fog else ((hit.t >= 0.0) & ~p_medium)
    p_emissive = p_active & (hit.index % cfg.emissive_every == 0)
    p_diffuse = (p_active & ~p_emissive) if not fog else (
        (p_active & ~p_emissive) | p_medium)
    p_miss = (hit.t == f32(-1.0)) if not fog else (
        (hit.t == f32(-1.0)) & ~p_medium)
    base = jnp.where(p_emissive, _emit_term(cfg, hit.emis_r2), f32(0.0))
    col_r = col_g = col_b = base

    def miss_env(cols):
        # The skipped-bounce branch (no diffuse lane in the block) still
        # owes the sky its radiance (glsl:312-314).
        col_r, col_g, col_b = cols
        if cfg.env_mode == "none":
            return col_r, col_g, col_b
        le = jnp.where(p_miss, _env_term(cfg, dx, dy, dz), f32(0.0))
        return col_r + le, col_g + le, col_b + le

    def run_bounces(cols):
        col_r, col_g, col_b = cols
        ones = jnp.ones(shape, f32)
        # dist: tri-state sentinel (>=0 hit, -1 miss, -2 terminated);
        # primary emissive/miss lanes are already resolved above.
        dist = jnp.where(p_emissive, f32(-2.0), hit.t)
        # prev_pdf: BSDF sampling pdf of the ray that produced the CURRENT
        # hit (for the MIS emission weight); primaries are deterministic.
        # emission_ok: under NEE, emission is only collected on camera-
        # direct hits; every diffuse vertex accounts for lights explicitly
        # (int32: doubles as a weight selector under fog + MIS).
        (_, _, _, bdx, bdy, bdz, tp_r, tp_g, tp_b,
         col_r, col_g, col_b, prev_pdf, emission_ok, survive,
         cast_ox, cast_oy, cast_oz) = _scatter_and_roulette(
            cfg, intersect, sampler, light_sampler, use_nee, use_mis,
            0, ox, oy, oz, dx, dy, dz, p_cur_t, hit.nx, hit.ny, hit.nz,
            p_index, p_diffuse, ones, ones, ones, col_r, col_g, col_b,
            ones, jnp.ones(shape, jnp.int32), stats=stats,
            medium=p_medium, lights=lights)
        dist = jnp.where(p_diffuse & ~survive, f32(-2.0), dist)
        # entered = p_diffuse | p_miss: the env site inside _finish_path
        # covers primary misses too (their dist stays -1, throughput 1,
        # direction d — see the note above).
        return _finish_path(
            cfg, intersect, sampler, 1, p_diffuse | p_miss, survive, dist,
            cast_ox, cast_oy, cast_oz, bdx, bdy, bdz, tp_r, tp_g, tp_b,
            col_r, col_g, col_b, prev_pdf, emission_ok,
            intersect_anyhit=intersect_anyhit,
            light_sampler=light_sampler,
            use_nee=use_nee, use_mis=use_mis, stats=stats, lights=lights)

    # Exactly ONE branch per sample, and only the three color sums cross
    # it; everything else the bounce loop touches stays local to the
    # branch, so it costs ~nothing when skipped and little when taken.
    if use_cond:
        col_r, col_g, col_b = jax.lax.cond(
            any_lane(p_diffuse), run_bounces, miss_env,
            (col_r, col_g, col_b))
    else:
        col_r, col_g, col_b = run_bounces((col_r, col_g, col_b))
    return col_r, col_g, col_b


# ---------------------------------------------------------------------------
# Debug / AOV channels (the reference's comment-toggled render modes,
# sphere_pathtracing.cs.glsl:386-389, triangle_pathtracing.cs.glsl:406-409)
# ---------------------------------------------------------------------------

def aov_normal(intersect, ox, oy, oz, dx, dy, dz, miss=(0.0, 0.0, 0.0),
               cfg=None):
    """Shading normal or the miss color (sphere: black, glsl:342-351;
    triangle: magenta, triangle_pathtracing.cs.glsl:328-341). With
    cfg.normal_map > 0 the displayed normal carries the procedural bump
    perturbation (the numeric surface the normal-mapping tests gate on)."""
    h = intersect(ox, oy, oz, dx, dy, dz)
    m = h.t >= 0.0
    nx, ny, nz = h.nx, h.ny, h.nz
    if cfg is not None and cfg.normal_map > 0.0:
        from l2n.maths.bump import perturb_normal
        nx, ny, nz = perturb_normal(cfg, h.index, ox + h.t * dx,
                                    oy + h.t * dy, oz + h.t * dz,
                                    nx, ny, nz)
    return (jnp.where(m, nx, jnp.float32(miss[0])),
            jnp.where(m, ny, jnp.float32(miss[1])),
            jnp.where(m, nz, jnp.float32(miss[2])))


def aov_hit(intersect, ox, oy, oz, dx, dy, dz):
    """1 on hit else 0 (CPU renderer's `hit`, src/main.cpp:366-374)."""
    h = intersect(ox, oy, oz, dx, dy, dz)
    v = (h.t >= 0.0).astype(jnp.float32)
    return v, v, v


def aov_ambient_occlusion(cfg, intersect, sampler, ox, oy, oz, dx, dy, dz,
                          intersect_primary=None):
    """One-bounce white-sky AO (sphere_pathtracing.cs.glsl:319-340):
    cosine-sample the hemisphere at the hit; white if the second ray
    escapes, black otherwise."""
    f32 = jnp.float32
    h = (intersect_primary or intersect)(ox, oy, oz, dx, dy, dz)
    active = h.t >= 0.0
    tangent, bitangent = frame_z(h.nx, h.ny, h.nz)
    u1, u2 = sampler.draw2(mask=active)
    (lx, ly, lz), _ = cosine_sample_hemisphere(u1, u2)
    wx, wy, wz = local_to_world(lx, ly, lz, tangent, bitangent,
                                (h.nx, h.ny, h.nz))
    sx = ox + h.t * dx + f32(cfg.ray_epsilon) * wx
    sy = oy + h.t * dy + f32(cfg.ray_epsilon) * wy
    sz = oz + h.t * dz + f32(cfg.ray_epsilon) * wz
    h2 = intersect(sx, sy, sz, wx, wy, wz)
    v = jnp.where(active & (h2.t < 0.0), f32(1.0), f32(0.0))
    return v, v, v


def aov_tex_coords(intersect, ox, oy, oz, dx, dy, dz):
    """Interpolated texcoords (triangle_pathtracing.cs.glsl:343-356);
    magenta on miss."""
    h = intersect(ox, oy, oz, dx, dy, dz)
    m = h.t >= 0.0
    tc_u = h.tc_u if h.tc_u is not None else jnp.zeros_like(h.t)
    tc_v = h.tc_v if h.tc_v is not None else jnp.zeros_like(h.t)
    one = jnp.float32(1.0)
    zero = jnp.float32(0.0)
    return (jnp.where(m, tc_u, one), jnp.where(m, tc_v, zero),
            jnp.where(m, zero, one))


def aov_param_uv(intersect, ox, oy, oz, dx, dy, dz):
    """Barycentric (u, v) of the hit (triangle_pathtracing.cs.glsl:358-371);
    magenta on miss."""
    h = intersect(ox, oy, oz, dx, dy, dz)
    m = h.t >= 0.0
    b_u = h.b_u if h.b_u is not None else jnp.zeros_like(h.t)
    b_v = h.b_v if h.b_v is not None else jnp.zeros_like(h.t)
    one = jnp.float32(1.0)
    zero = jnp.float32(0.0)
    return (jnp.where(m, b_u, one), jnp.where(m, b_v, zero),
            jnp.where(m, zero, one))


def shade(cfg, intersect: IntersectFn, sampler, ox, oy, oz, dx, dy, dz,
          miss_color=(0.0, 0.0, 0.0), skip_empty: bool = False,
          intersect_primary: IntersectFn | None = None,
          intersect_anyhit=None, light_sampler=None, lights=None):
    """Dispatch on cfg.aov (static). `intersect_primary` (optional) is a
    sweep specialized for the camera cast; `intersect_anyhit` (optional) a
    boolean sweep for the last segment; AOVs are all primary-only except
    the second AO ray."""
    primary = intersect_primary or intersect
    if cfg.aov == "pathtracing":
        return trace_path(cfg, intersect, sampler, ox, oy, oz, dx, dy, dz,
                          skip_empty=skip_empty,
                          intersect_primary=intersect_primary,
                          intersect_anyhit=intersect_anyhit,
                          light_sampler=light_sampler, lights=lights)
    if cfg.aov == "normal":
        return aov_normal(primary, ox, oy, oz, dx, dy, dz, miss_color,
                          cfg=cfg)
    if cfg.aov == "hit":
        return aov_hit(primary, ox, oy, oz, dx, dy, dz)
    if cfg.aov == "ambient_occlusion":
        return aov_ambient_occlusion(cfg, intersect, sampler,
                                     ox, oy, oz, dx, dy, dz,
                                     intersect_primary=intersect_primary)
    if cfg.aov == "tex_coords":
        return aov_tex_coords(primary, ox, oy, oz, dx, dy, dz)
    if cfg.aov == "param_uv":
        return aov_param_uv(primary, ox, oy, oz, dx, dy, dz)
    raise ValueError(f"unknown aov {cfg.aov!r}")
