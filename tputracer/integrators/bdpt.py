"""Wavefront bidirectional path tracer: vertex connection + MIS (SURVEY.md
§2 row 14, §3.3; BASELINE config 4 "BDPT with vertex connection + MIS on a
caustics scene").

The reference's BDPT is a per-pixel double loop: random-walk an eye subpath
and a light subpath, then connect every (s, t) vertex pair with a shadow
ray and a multiple-importance-sampling weight (SURVEY.md §3.3).  The
wavefront form:

  * both subpath walks are **wavefront passes** over the whole path batch —
    the same bounce-major SoA advance as integrators.pt, run twice (once
    from the camera, once from the emitters, in importance transport);
  * each subpath stores a **vertex SoA** per depth: position, normal,
    throughput beta, forward/reverse area-measure pdfs, material tag,
    delta flag — the pdfFwd/pdfRev chains that make MIS weights a
    closed-form product ratio instead of a recursion;
  * the (s, t) **connection double loop is statically unrolled** (depths
    are small compile-time constants): each strategy is one fully masked
    batch — a batched BSDF eval at both endpoints, one batched shadow-ray
    any-hit, and a vectorized MIS ratio chain.  No divergence, no dynamic
    shapes; XLA fuses each strategy into a few elementwise passes plus
    the occlusion test;
  * **t=1 light tracing** (the caustics strategy) splats light-subpath
    vertices through the pinhole onto the film with a ``segment_sum``
    scatter — the deterministic form of the reference's "racy in spirit"
    film splat (SURVEY.md §7 hard part 2).

MIS bookkeeping follows the standard area-measure formulation (Veach '97
ch. 10): every vertex stores pdf_fwd / pdf_rev — the probability per unit
area of sampling that vertex from the walk's own direction and from the
opposite direction — and the weight for strategy (s, t) is

    w = 1 / (1 + sum_i prod ratios)     (balance heuristic)

with delta vertices contributing ratio 1 and suppressing their adjacent
(unsamplable) strategies, and per-strategy overrides of the four pdf_rev
values at the connection endpoints.

RNG discipline matches integrators.pt: all streams are counter-based on
the global path uid, so BDPT renders are chunking- and sharding-invariant.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tputracer import geometry as g
from tputracer import rng
from tputracer.accel import intersect, occluded
from tputracer.bsdf import emitted, eval_bsdf, pdf_bsdf, sample_bsdf
from tputracer.integrators.pt import camera_rays, film_from_radiance
from tputracer.lights import pdf_light_area, sample_light
from tputracer.scene.types import DIFFUSE

_BIG = 3.0e38                       # python floats — see accel/bruteforce.py
_PI = float(__import__('math').pi)


def _remap0(x):
    """Map 0 pdfs to 1 so delta/invalid factors drop out of ratio chains."""
    return jnp.where(x > 0.0, x, 1.0)


def _convert_density(pdf_sa, p_from, p_to, n_to):
    """Solid-angle pdf at p_from -> area-measure pdf at p_to."""
    w = p_to - p_from
    dist2 = jnp.maximum(g.dot(w, w), 1e-12)
    inv = 1.0 / dist2
    cos = jnp.abs(g.dot(n_to, w)) * jnp.sqrt(inv)
    return pdf_sa * cos * inv


def _camera_forward(cam):
    """Unit forward axis of the pinhole camera (3,)."""
    c = cam.corner + 0.5 * cam.du + 0.5 * cam.dv - cam.o
    return c / jnp.sqrt(jnp.maximum(jnp.sum(c * c), 1e-20))


def _camera_area(cam):
    """World-space area of the image plane at unit distance (scalar)."""
    cr = jnp.cross(cam.du, cam.dv)
    return jnp.sqrt(jnp.maximum(jnp.sum(cr * cr), 1e-20))


def _camera_pdf_sa(cam, d):
    """Solid-angle pdf of a camera ray direction d (N,3) -> (N,).

    uv is uniform over the full film, so p(w) = 1 / (A cos^3 theta) with
    A = |du x dv| (image plane at unit distance along the forward axis).
    """
    w_fwd = _camera_forward(cam)
    cos = jnp.maximum(jnp.sum(d * w_fwd[None, :], axis=-1), 1e-6)
    return 1.0 / (_camera_area(cam) * cos**3)


def _walk(scene, o, d, beta, pdf_sa, uid, cfg, n_verts, slot, origin,
          transport_radiance, start_p=None, isect=None, stats_acc=None):
    """Random walk of up to n_verts surface vertices; returns vertex list.

    Each vertex is a dict of (N,)-leading SoA arrays:
      p, ng, wo (unit toward predecessor), beta (throughput ARRIVING at
      the vertex), pdf_fwd / pdf_rev (area measure), mat, prim, delta,
      valid.  pdf_rev of vertex i is written one step later (it needs the
      walk's next direction); ``origin`` (light-walk y0) receives its
      pdf_rev the same way.

    Dead lanes get tmax=0 (round-5, matching integrators.pt): the
    traversal kernels then skip all-dead subtiles, and the live-lane
    count is the honest "rays issued" stat (stats_acc["rays_closest"]
    when a stats dict is passed).
    """
    n = o.shape[0]
    isect = intersect if isect is None else isect
    zeros1 = jnp.zeros((n,), jnp.float32)
    eps = jnp.float32(scene.eps)
    prev_p = o if start_p is None else start_p
    prev = origin
    alive = jnp.ones((n,), bool)
    verts = []
    for i in range(n_verts):
        if stats_acc is not None:
            stats_acc["rays_closest"] = (
                stats_acc.get("rays_closest", 0.0)
                + jnp.sum(alive.astype(jnp.float32)))
        hit = isect(scene, o, d, tmin=zeros1,
                    tmax=jnp.where(alive, _BIG, 0.0))
        valid = alive & hit.valid
        pdf_fwd = _convert_density(pdf_sa, prev_p, hit.p, hit.n)
        kind = scene.mat_kind[hit.mat]
        v = dict(
            p=hit.p,
            ng=hit.n,
            wo=-d,
            beta=beta,
            pdf_fwd=jnp.where(valid, pdf_fwd, 0.0),
            pdf_rev=zeros1,
            mat=hit.mat,
            prim=hit.prim,
            delta=(kind != DIFFUSE) & valid,
            valid=valid,
        )
        verts.append(v)
        if i == n_verts - 1:
            break

        wo = -d
        u0, u1, u2 = rng.uniform3(uid, rng.salt(i, slot), cfg.seed)
        wi, wgt, pdf_b, _ = sample_bsdf(
            scene, hit.mat, hit.n, wo, u0, u1, u2,
            transport_radiance=transport_radiance,
        )
        # reverse pdf of the PREVIOUS vertex: prob of sampling wo (toward
        # the predecessor) given incoming wi — 0 through delta scatters,
        # which remap0 + the delta-strategy suppression handle (Veach).
        rev_sa = pdf_bsdf(scene, hit.mat, hit.n, wi, wo)
        if prev is not None:
            pr = _convert_density(rev_sa, hit.p, prev["p"], prev["ng"])
            prev["pdf_rev"] = jnp.where(valid, pr, prev["pdf_rev"])

        beta = beta * wgt
        side = jnp.where(g.dot(wi, hit.n) >= 0.0, 1.0, -1.0)
        prev_p = hit.p
        o = hit.p + hit.n * (side * eps)[:, None]
        d = wi
        pdf_sa = pdf_b
        alive = valid & (jnp.max(beta, axis=-1) > 0.0)
        prev = v
    return verts


def _mis_weight(scene, cam, ys, zs, s, t, power=False):
    """MIS weight of strategy (s, t) over all strategies that sample the
    same full path.  ys/zs are the light/eye vertex lists; the
    connection joins ys[s-1] and zs[t-1] (s=0: zs[t-1] lies ON a
    light).  Returns (N,) weights; garbage on lanes the caller masks out.

    power=False: balance heuristic w = p_s / sum_i p_i (default).
    power=True: Veach power heuristic with beta=2, w = p_s^2 / sum_i
    p_i^2 — each accumulated pdf ratio is squared; the running ratio
    chain itself stays linear.  SURVEY.md §3.3 describes the reference
    as power-heuristic, but the mount is empty (SURVEY §0) so the
    default stays the balance heuristic until a re-survey can confirm;
    both satisfy the weight-sum==1 identity
    (tests/golden/test_bdpt_mis_weights.py runs both).
    """
    fwd_z = [v["pdf_fwd"] for v in zs[:t]]
    rev_z = [v["pdf_rev"] for v in zs[:t]]
    del_z = [v["delta"] for v in zs[:t]]
    fwd_y = [v["pdf_fwd"] for v in ys[:s]]
    rev_y = [v["pdf_rev"] for v in ys[:s]]
    del_y = [v["delta"] for v in ys[:s]]

    z = zs[t - 1]
    if s == 0:
        # zs[t-1] is on an emitter: its "reverse" pdf is the light-origin
        # area pdf; zs[t-2]'s is the light's cosine emission pdf.
        pl, _ = pdf_light_area(scene, z["prim"])
        rev_z[t - 1] = pl
        if t >= 2:
            cos_l = jnp.maximum(g.dot(z["ng"], z["wo"]), 0.0)
            rev_z[t - 2] = _convert_density(
                cos_l / _PI, z["p"], zs[t - 2]["p"], zs[t - 2]["ng"])
    else:
        y = ys[s - 1]
        d_zy = y["p"] - z["p"]
        dist = jnp.sqrt(jnp.maximum(g.dot(d_zy, d_zy), 1e-12))
        d_zy = d_zy / dist[:, None]
        d_yz = -d_zy

        # pdf of z from the light side
        if s == 1:
            sa = jnp.maximum(g.dot(y["ng"], d_yz), 0.0) / _PI
        else:
            sa = pdf_bsdf(scene, y["mat"], y["ng"], y["wo"], d_yz)
        rev_z[t - 1] = _convert_density(sa, y["p"], z["p"], z["ng"])

        # pdf of z's predecessor, from the light side through z
        if t >= 2:
            sa = pdf_bsdf(scene, z["mat"], z["ng"], d_zy, z["wo"])
            rev_z[t - 2] = _convert_density(
                sa, z["p"], zs[t - 2]["p"], zs[t - 2]["ng"])

        # pdf of y from the eye side
        if t == 1:
            sa = _camera_pdf_sa(cam, d_zy)  # z is the camera here
        else:
            sa = pdf_bsdf(scene, z["mat"], z["ng"], z["wo"], d_zy)
        rev_y[s - 1] = _convert_density(sa, z["p"], y["p"], y["ng"])

        # pdf of y's predecessor, from the eye side through y
        if s >= 2:
            sa = pdf_bsdf(scene, y["mat"], y["ng"], d_yz, y["wo"])
            rev_y[s - 2] = _convert_density(
                sa, y["p"], ys[s - 2]["p"], ys[s - 2]["ng"])

    n = zs[0]["pdf_fwd"].shape[0]
    sum_ri = jnp.zeros((n,), jnp.float32)
    ri = jnp.ones((n,), jnp.float32)
    # hypothetical strategies that move the connection toward the camera
    for i in range(t - 1, 0, -1):
        ri = ri * _remap0(rev_z[i]) / _remap0(fwd_z[i])
        ok = jnp.logical_not(del_z[i]) & jnp.logical_not(del_z[i - 1])
        sum_ri = sum_ri + jnp.where(ok, ri * ri if power else ri, 0.0)
    # ... and toward the light (area lights are never delta).  The two
    # chains are INDEPENDENT products (Veach '97 eq. 10.9 / PBRT v3
    # MISWeight): each starts from ratio 1 at the connection edge.
    ri = jnp.ones((n,), jnp.float32)
    for i in range(s - 1, -1, -1):
        ri = ri * _remap0(rev_y[i]) / _remap0(fwd_y[i])
        ok = jnp.logical_not(del_y[i])
        if i > 0:
            ok = ok & jnp.logical_not(del_y[i - 1])
        sum_ri = sum_ri + jnp.where(ok, ri * ri if power else ri, 0.0)
    return 1.0 / (1.0 + sum_ri)


def eye_subpaths(scene, uid, cfg, isect=None, stats_acc=None):
    """Camera vertex + wavefront eye walk -> vertex SoA list zs."""
    n = uid.shape[0]
    cam = scene.camera
    E = cfg.max_bounces + 1       # surface vertices per subpath
    o, d = camera_rays(scene, uid, cfg)
    w_fwd = _camera_forward(cam)
    cam_v = dict(
        p=jnp.broadcast_to(cam.o[None, :], (n, 3)),
        ng=jnp.broadcast_to(w_fwd[None, :], (n, 3)),
        wo=jnp.zeros((n, 3), jnp.float32),
        beta=jnp.ones((n, 3), jnp.float32),
        pdf_fwd=jnp.ones((n,), jnp.float32),
        pdf_rev=jnp.zeros((n,), jnp.float32),
        mat=jnp.zeros((n,), jnp.int32),
        prim=jnp.full((n,), -1, jnp.int32),
        delta=jnp.zeros((n,), bool),
        valid=jnp.ones((n,), bool),
    )
    return [cam_v] + _walk(
        scene, o, d, jnp.ones((n, 3), jnp.float32), _camera_pdf_sa(cam, d),
        uid, cfg, E, rng.SLOT_BSDF, origin=None, transport_radiance=True,
        isect=isect, stats_acc=stats_acc)


def light_subpaths(scene, uid, cfg, isect=None, stats_acc=None):
    """Emitter sample + importance-transport walk -> vertex SoA list ys."""
    n = uid.shape[0]
    eps = jnp.float32(scene.eps)
    E = cfg.max_bounces + 1
    u0, u1, u2 = rng.uniform3(uid, rng.salt(0, rng.SLOT_LIGHT_ORIGIN), cfg.seed)
    yp, n_l, le, pdf_a, lprim, lmat = sample_light(scene, u0, u1, u2)
    y0 = dict(
        p=yp,
        ng=n_l,
        wo=jnp.zeros((n, 3), jnp.float32),
        beta=le / pdf_a[:, None],
        pdf_fwd=pdf_a,
        pdf_rev=jnp.zeros((n,), jnp.float32),
        mat=lmat,
        prim=lprim,
        delta=jnp.zeros((n,), bool),
        valid=jnp.ones((n,), bool),
    )
    v0, v1, v2 = rng.uniform3(uid, rng.salt(0, rng.SLOT_LIGHT_DIR), cfg.seed)
    d0 = g.to_world(g.cosine_sample_hemisphere(v1, v2), n_l)
    pdf_d0 = jnp.maximum(g.dot(d0, n_l), 0.0) / _PI
    return [y0] + _walk(
        scene, yp + n_l * eps, d0, y0["beta"] * _PI, pdf_d0,
        uid, cfg, E, rng.SLOT_LBSDF, origin=y0,
        transport_radiance=False, start_p=yp, isect=isect,
        stats_acc=stats_acc)


def s0_radiance(scene, cfg, zs):
    """s=0 strategies: the eye path hits an emitter (weighted
    unidirectional).  Depends only on the eye subpath."""
    cam = scene.camera
    n = zs[0]["pdf_fwd"].shape[0]
    V = cfg.max_bounces + 2
    L_own = jnp.zeros((n, 3), jnp.float32)
    for t in range(2, min(len(zs), V) + 1):
        z = zs[t - 1]
        le_hit = emitted(scene, z["mat"], z["ng"], -z["wo"])
        _, is_em = pdf_light_area(scene, z["prim"])
        w = _mis_weight(scene, cam, [], zs, 0, t,
                        power=cfg.mis_power)
        mask = z["valid"] & is_em
        L_own = L_own + jnp.where(
            mask[:, None], z["beta"] * le_hit * w[:, None], 0.0)
    return L_own


def connection_radiance(scene, cfg, ys, zs, occl=None, stats_acc=None):
    """s>=1, t>=2 vertex-connection strategies: one masked batch + one
    shadow-ray batch per (s, t).  ys and zs may come from DIFFERENT path
    sets (the ring-sharded renderer pairs each eye subpath with rotated
    light-subpath blocks — SURVEY.md §2 SP row)."""
    cam = scene.camera
    occl = occluded if occl is None else occl
    eps = jnp.float32(scene.eps)
    n = zs[0]["pdf_fwd"].shape[0]
    V = cfg.max_bounces + 2
    L_own = jnp.zeros((n, 3), jnp.float32)
    for t in range(2, len(zs) + 1):
        for s in range(1, min(len(ys), V - t) + 1):
            y, z = ys[s - 1], zs[t - 1]
            d_raw = y["p"] - z["p"]
            dist2 = jnp.maximum(g.dot(d_raw, d_raw), 1e-12)
            dist = jnp.sqrt(dist2)
            d_zy = d_raw / dist[:, None]
            d_yz = -d_zy
            f_z = eval_bsdf(scene, z["mat"], z["ng"], z["wo"], d_zy)
            if s == 1:
                # y0 IS the emitter sample: Le sits in beta; the "BSDF"
                # at the light is its one-sided emission indicator
                f_y = (g.dot(y["ng"], d_yz) > 0.0).astype(jnp.float32)[:, None]
            else:
                f_y = eval_bsdf(scene, y["mat"], y["ng"], y["wo"], d_yz)
            G = (jnp.abs(g.dot(z["ng"], d_zy))
                 * jnp.abs(g.dot(y["ng"], d_yz)) / dist2)
            c = z["beta"] * f_z * f_y * y["beta"] * G[:, None]
            mask = (z["valid"] & y["valid"]
                    & jnp.logical_not(z["delta"])
                    & jnp.logical_not(y["delta"])
                    & (jnp.max(c, axis=-1) > 0.0))
            # only candidate connections trace shadow rays (tmax=0
            # skips masked lanes in the traversal, as in pt.py's NEE);
            # their count is the honest shadow-ray stat
            if stats_acc is not None:
                stats_acc["rays_shadow"] = (
                    stats_acc.get("rays_shadow", 0.0)
                    + jnp.sum(mask.astype(jnp.float32)))
            o_s = z["p"] + g.face_forward(z["ng"], d_zy) * eps
            occ = occl(scene, o_s, d_zy,
                       tmax=jnp.where(mask, dist * (1.0 - 1e-3), 0.0))
            mask = mask & jnp.logical_not(occ)
            w = _mis_weight(scene, cam, ys, zs, s, t,
                            power=cfg.mis_power)
            L_own = L_own + jnp.where(mask[:, None], c * w[:, None], 0.0)
    return L_own


def t1_splats(scene, cfg, ys, zs, occl=None, stats_acc=None):
    """t=1 light-tracing strategies: splat light-subpath vertices through
    the pinhole onto the film (segment_sum scatter).  Depends only on the
    light subpath (zs supplies just the shared camera vertex for the MIS
    chain).  Returns (H*W, 3) in uid pixel layout (row 0 = bottom)."""
    cam = scene.camera
    occl = occluded if occl is None else occl
    w_fwd = _camera_forward(cam)
    n = ys[0]["pdf_fwd"].shape[0]
    V = cfg.max_bounces + 2
    n_pix = cfg.width * cfg.height
    splat = jnp.zeros((n_pix, 3), jnp.float32)
    A = _camera_area(cam)
    for s in range(1, min(len(ys), V - 1) + 1):
        y = ys[s - 1]
        d_raw = y["p"] - cam.o[None, :]
        dist2 = jnp.maximum(g.dot(d_raw, d_raw), 1e-12)
        dist = jnp.sqrt(dist2)
        d_cy = d_raw / dist[:, None]                 # camera -> y
        cos_c = jnp.sum(d_cy * w_fwd[None, :], axis=-1)
        in_front = cos_c > 1e-6
        # project onto the unit-distance image plane -> film uv
        q = d_cy / jnp.maximum(cos_c, 1e-6)[:, None]
        rel = q - (cam.corner - cam.o)[None, :]
        uu = g.dot(rel, cam.du[None, :]) / jnp.maximum(
            jnp.sum(cam.du * cam.du), 1e-20)
        vv = g.dot(rel, cam.dv[None, :]) / jnp.maximum(
            jnp.sum(cam.dv * cam.dv), 1e-20)
        px = jnp.floor(uu * cfg.width).astype(jnp.int32)
        py = jnp.floor(vv * cfg.height).astype(jnp.int32)
        on_film = ((px >= 0) & (px < cfg.width)
                   & (py >= 0) & (py < cfg.height) & in_front)

        if s == 1:
            f_y = (g.dot(y["ng"], -d_cy) > 0.0).astype(jnp.float32)[:, None]
        else:
            f_y = eval_bsdf(scene, y["mat"], y["ng"], y["wo"], -d_cy)
        cos_y = jnp.abs(g.dot(y["ng"], d_cy))
        # importance: W = WH / (A cos^3); camera->y conversion adds cos_y/r^2
        imp = (cfg.width * cfg.height) / (A * jnp.maximum(cos_c, 1e-6) ** 3)
        c = y["beta"] * f_y * (imp * cos_y / dist2)[:, None]
        mask = (y["valid"] & jnp.logical_not(y["delta"]) & on_film
                & (jnp.max(c, axis=-1) > 0.0))
        if stats_acc is not None:
            stats_acc["rays_shadow"] = (
                stats_acc.get("rays_shadow", 0.0)
                + jnp.sum(mask.astype(jnp.float32)))
        occ = occl(
            scene, jnp.broadcast_to(cam.o[None, :], (n, 3)), d_cy,
            tmax=jnp.where(mask, dist * (1.0 - 1e-3), 0.0))
        mask = mask & jnp.logical_not(occ)
        w = _mis_weight(scene, cam, ys, zs, s, 1,
                        power=cfg.mis_power)
        c = jnp.where(mask[:, None], c * w[:, None], 0.0)
        pix_id = jnp.where(mask, py * cfg.width + px, n_pix)
        splat = splat + jax.ops.segment_sum(
            c, pix_id, num_segments=n_pix + 1)[:n_pix]
    return splat


def trace_bdpt(scene, uid, cfg, intersect_fn=None, occluded_fn=None):
    """BDPT radiance for a chunk of paths.

    Returns (L_own (n,3) per-path radiance for t>=2 strategies,
             splat (H*W, 3) film scatter from t=1 light tracing — in uid
             pixel layout (row 0 = bottom), NOT yet divided by the global
             path count).

    intersect_fn / occluded_fn: optional traversal backends with the
    accel.intersect / accel.occluded signatures — the geometry-tiled
    renderer (dist.scene_shard.render_bdpt_tiled) plugs its ring
    traversal in here, exactly like integrators.pt.trace_radiance.

    Also returns stats (round-5 honest ray accounting, the BDPT
    counterpart of pt.trace_radiance's): "rays_closest" = live subpath
    segments actually traced across both walks, "rays_shadow" =
    candidate connection + t=1 shadow rays actually traced.
    """
    acc = {}
    zs = eye_subpaths(scene, uid, cfg, isect=intersect_fn, stats_acc=acc)
    ys = light_subpaths(scene, uid, cfg, isect=intersect_fn, stats_acc=acc)
    L_own = s0_radiance(scene, cfg, zs) + connection_radiance(
        scene, cfg, ys, zs, occl=occluded_fn, stats_acc=acc)
    splat = t1_splats(scene, cfg, ys, zs, occl=occluded_fn, stats_acc=acc)
    stats = {"rays_closest": acc.get("rays_closest", jnp.float32(0.0)),
             "rays_shadow": acc.get("rays_shadow", jnp.float32(0.0))}
    return L_own, splat, stats


def trace_bdpt_rows(scene, uids, cfg, rows_budget=None,
                    intersect_fn=None, occluded_fn=None,
                    samples_per_pixel=None):
    """Trace a uid array covering whole image rows in row-aligned chunks.

    Returns (L_own (n,3) in uid order, splat (H*W,3) film scatter,
    stats dict of summed ray counters).
    Chunking is on whole image rows: padding is not an option here
    (padded paths would still SPLAT onto real pixels), so the chunk is
    the largest row count that divides the range and fits the budget.
    Shared by the single-device and shard_map renderers, and (with
    samples_per_pixel=step < cfg.spp) by the progressive passes, whose
    uid arrays hold only a SLICE of each pixel's samples.
    """
    n = uids.shape[0]
    per_row = cfg.width * (samples_per_pixel or cfg.spp)
    n_rows = n // per_row
    assert n_rows * per_row == n, (n, per_row)
    rows = max(1, min((rows_budget or cfg.chunk_size) // per_row, n_rows))
    while n_rows % rows:
        rows -= 1
    chunk = rows * per_row
    L_parts, splat_sum = [], jnp.zeros(
        (cfg.width * cfg.height, 3), jnp.float32)
    stats = None
    for i in range(n // chunk):
        L, sp, st = trace_bdpt(scene, uids[i * chunk:(i + 1) * chunk], cfg,
                               intersect_fn=intersect_fn,
                               occluded_fn=occluded_fn)
        L_parts.append(L)
        splat_sum = splat_sum + sp
        stats = st if stats is None else jax.tree.map(
            lambda a, b: a + b, stats, st)
    return jnp.concatenate(L_parts, axis=0), splat_sum, stats


def render_bdpt(scene, cfg):
    """Full-frame BDPT render -> (image (H,W,3), stats); row 0 = top.

    film = mean over per-pixel samples of t>=2 strategies
         + (1 / total paths) * scatter of t=1 splats  (SURVEY.md §3.3).
    """
    n_total = cfg.width * cfg.height * cfg.spp
    uids = jnp.arange(n_total, dtype=jnp.uint32)
    L_own, splat_sum, stats = trace_bdpt_rows(scene, uids, cfg)
    img = film_from_radiance(L_own, cfg)
    splat_img = (splat_sum / jnp.float32(n_total)).reshape(
        cfg.height, cfg.width, 3)[::-1]
    stats = dict(stats, splat_energy=jnp.sum(splat_sum))
    return img + splat_img, stats
