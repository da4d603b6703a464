"""Wavefront unidirectional path tracer (SURVEY.md §2 row 13, §3.2).

The reference's recursive ``radiance(ray, depth)`` (SURVEY.md §3.2) is
inverted into a bounce-major wavefront: one SoA state
{o, d, throughput, L, alive, gate} for a chunk of paths, advanced by an
unrolled static bounce loop inside a single jit.  Recursion, early-outs
and Russian roulette all become lane masks — no data-dependent control
flow, so each bounce is one intersection call (a GPU kernel or the XLA
reference, accel) plus fully fused elementwise shading.

Per bounce b (mirrors the reference semantics):
  1. closest-hit intersect (Pluecker test; accel)
  2. add emission — gated: at b==0, after a delta bounce, or (mis mode)
     weighted by the power heuristic against the NEE strategy
  3. NEE: sample an emitter point, one batched shadow-ray any-hit
  4. sample the BSDF, update throughput (detached-sampling grads)
  5. Russian roulette from cfg.rr_start on

RNG is counter-based (tputracer.rng) keyed by global path uid — streams
are identical regardless of chunking or sharding, and the NumPy oracle
(tests/oracle) consumes the *same* streams, enabling near-exact golden
tests instead of loose statistical ones.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from tputracer import geometry as g
from tputracer import rng
from tputracer.accel import intersect, occluded
from tputracer.bsdf import (emitted, eval_bsdf, nee_nonspecular, pdf_bsdf,
                            sample_bsdf)
from tputracer.lights import pdf_light_area, sample_light

_BIG = 3.0e38  # python float — see accel/bruteforce.py note


def _power2(a, b):
    """Power heuristic (beta=2) MIS weight for strategy a vs b."""
    a2 = a * a
    return a2 / jnp.maximum(a2 + b * b, 1e-20)


def camera_rays(scene, uid, cfg):
    """Primary rays with per-sample pixel jitter (SURVEY.md §2 row 12)."""
    cam = scene.camera
    pix = (uid // jnp.uint32(cfg.spp)).astype(jnp.int32)
    px = (pix % cfg.width).astype(jnp.float32)
    py = (pix // cfg.width).astype(jnp.float32)
    j0, j1, _ = rng.uniform3(uid, rng.salt(0, rng.SLOT_CAMERA), cfg.seed)
    u = (px + j0) * (1.0 / cfg.width)
    v = (py + j1) * (1.0 / cfg.height)
    d = g.normalize(
        cam.corner[None, :]
        + u[:, None] * cam.du[None, :]
        + v[:, None] * cam.dv[None, :]
        - cam.o[None, :]
    )
    o = jnp.broadcast_to(cam.o[None, :], d.shape)
    return o, d


def _coherence_key(scene, o, d, alive):
    """Wavefront sort key (SURVEY.md §7 M5): dead lanes last; live lanes
    grouped by origin cell (4^3 grid over the scene bounds) then
    direction octant, so traversal tiles visit fewer clusters."""
    lo = jnp.min(scene.clus_min, axis=0)
    hi = jnp.max(scene.clus_max, axis=0)
    cell = jnp.clip(((o - lo) / (hi - lo + 1e-9) * 4.0).astype(jnp.int32),
                    0, 3)
    octant = ((d[:, 0] >= 0).astype(jnp.int32)
              + 2 * (d[:, 1] >= 0).astype(jnp.int32)
              + 4 * (d[:, 2] >= 0).astype(jnp.int32))
    key = (cell[:, 0] * 16 + cell[:, 1] * 4 + cell[:, 2]) * 8 + octant
    return jnp.where(alive, key, 1 << 14)


def _bounce_step(scene, decision_scene, uid, carry, *, b, cfg, isect, occl):
    """One wavefront bounce: intersect, emission, NEE, BSDF sample, RR.

    carry = (o, d, L, thr, alive, prev_delta, prev_pdf); returns
    (carry', (rays_issued, n_active, rays_shadow)) with rays_shadow None
    on the terminal bounce (no continuation).  Factored out of
    trace_radiance so cfg.remat can jax.checkpoint each bounce: the
    backward pass then stores only the ~13-floats/path carry at bounce
    boundaries and rematerializes bounce internals (hit buffers, MT
    intermediates) instead of spilling them all to HBM.
    """
    o, d, L, thr, alive, prev_delta, prev_pdf = carry
    n = uid.shape[0]
    zeros1 = jnp.zeros((n,), jnp.float32)
    eps = jnp.float32(scene.eps)

    # dead lanes get tmax=0: the traversal's (t_enter < best_t)
    # admission test can then never pull a cluster in, so an
    # all-dead tile costs one slab pass and exits — this is what
    # makes the alive-first wavefront sort an actual compaction
    # (SURVEY.md §7 M5), not just a reordering
    issued = jnp.sum(alive.astype(jnp.float32))
    with jax.named_scope(f"bounce{b}_traverse"):
        hit = isect(scene, o, d, tmin=zeros1,
                    tmax=jnp.where(alive, _BIG, 0.0))
    active = alive & hit.valid
    n_active = jnp.sum(active.astype(jnp.float32))

    # ---- emission at the hit vertex ----
    le = emitted(scene, hit.mat, hit.n, d)
    if cfg.mis and b > 0:
        pl_area, is_em = pdf_light_area(scene, hit.prim)
        cos_l = jnp.abs(g.dot(hit.n, d))
        # missed lanes carry t=_BIG whose square overflows to inf and
        # NaN-poisons the power-heuristic backward; clamp them out
        t_safe = jnp.where(hit.valid, hit.t, 1.0)
        pl_sa = pl_area * t_safe**2 / jnp.maximum(cos_l, 1e-6)
        w_hit = jnp.where(prev_delta, 1.0, _power2(prev_pdf, pl_sa))
    else:
        # NEE-only: emitters counted at b==0 (prev_delta init) or after
        # a delta bounce — the reference's double-count guard (§3.2)
        w_hit = prev_delta.astype(jnp.float32)
    L = L + jnp.where(active[:, None], thr * le * w_hit[:, None], 0.0)

    if b == cfg.max_bounces:
        return (o, d, L, thr, alive, prev_delta, prev_pdf), \
            (issued, n_active, None)

    wo = -d
    ns = g.face_forward(hit.n, wo)

    # ---- next-event estimation (SURVEY.md §3.2 NEE block) ----
    ul0, ul1, ul2 = rng.uniform3(uid, rng.salt(b, rng.SLOT_LIGHT), cfg.seed)
    y, n_l, le_l, pdf_a, _, _ = sample_light(scene, ul0, ul1, ul2)
    to_l = y - hit.p
    dist2 = jnp.maximum(g.dot(to_l, to_l), 1e-12)
    dist = jnp.sqrt(dist2)
    wi_l = to_l / dist[:, None]
    cos_p = g.dot(wi_l, ns)
    cos_l = g.dot(n_l, -wi_l)
    geom_ok = (cos_p > 0.0) & (cos_l > 1e-6)
    f = eval_bsdf(scene, hit.mat, hit.n, wo, wi_l)
    # only trace shadow rays that can contribute: live lane, light
    # facing, and a lobe that can eval nonzero (delta lobes never do —
    # their shadow rays were pure waste).  The gate is STRUCTURAL
    # (material kind), not f>0: a diffuse lane with albedo exactly 0
    # still traces, so its NEE gradient survives (round-2 advisor).
    # Masked lanes get tmax=0 so the traversal skips them like dead
    # lanes above.
    want = active & geom_ok & nee_nonspecular(scene, hit.mat)
    n_shadow = jnp.sum(want.astype(jnp.float32))
    so = hit.p + ns * eps
    with jax.named_scope(f"bounce{b}_nee_shadow"):
        occ = occl(scene, so, wi_l,
                   tmax=jnp.where(want, dist * (1.0 - 1e-3), 0.0))
    pdf_sa = pdf_a * dist2 / jnp.maximum(cos_l, 1e-6)
    if cfg.mis:
        pb = pdf_bsdf(scene, hit.mat, hit.n, wo, wi_l)
        w_nee = _power2(pdf_sa, pb)
    else:
        w_nee = 1.0
    contrib = thr * f * le_l * (w_nee * cos_p / pdf_sa)[:, None]
    nee_on = want & jnp.logical_not(occ)
    L = L + jnp.where(nee_on[:, None], contrib, 0.0)

    # ---- BSDF sampling / continuation ----
    ub0, ub1, ub2 = rng.uniform3(uid, rng.salt(b, rng.SLOT_BSDF), cfg.seed)
    wi, wgt, pdf_b, is_delta = sample_bsdf(
        scene, hit.mat, hit.n, wo, ub0, ub1, ub2,
        transport_radiance=cfg.transport_radiance,
        decision_scene=decision_scene,
    )
    thr = thr * wgt

    # ---- Russian roulette ----
    if b >= cfg.rr_start:
        ur, _, _ = rng.uniform3(uid, rng.salt(b, rng.SLOT_RR), cfg.seed)
        # q is the probability of a DETACHED discrete decision: detach
        # it (SURVEY.md §7 hard part 3 — differentiating the 1/q
        # compensation through q biases the estimator)
        q = lax.stop_gradient(jnp.clip(jnp.max(thr, axis=-1), 0.05, 0.95))
        active = active & (ur < q)
        thr = thr / q[:, None]

    side = jnp.where(g.dot(wi, hit.n) >= 0.0, 1.0, -1.0)
    o = hit.p + hit.n * (side * eps)[:, None]
    d = wi
    prev_delta = is_delta
    prev_pdf = pdf_b
    alive = active & (jnp.max(thr, axis=-1) > 0.0)
    return (o, d, L, thr, alive, prev_delta, prev_pdf), \
        (issued, n_active, n_shadow)


def trace_radiance(scene, uid, cfg, decision_scene=None,
                   intersect_fn=None, occluded_fn=None):
    """Radiance for a chunk of paths. uid: (n,) uint32 -> (L (n,3), stats).

    decision_scene: optional frozen Scene driving discrete sampling
    decisions (see bsdf.sample_bsdf) — used by the FD gradient tests.
    intersect_fn / occluded_fn: optional intersection backends with the
    accel.intersect / accel.occluded signatures — the scene-tiled
    renderer (dist.scene_shard) plugs its ring traversal in here.

    With cfg.sort_rays (clustered scenes only), the wavefront is
    re-permuted each bounce by _coherence_key.  The counter-based RNG is
    keyed on uid, so streams are permutation-invariant and the result is
    identical to the unsorted path; L is restored to uid order at the
    end.  This trades ~n log n sort + full-state gathers per bounce for
    fewer cluster visits per traversal tile — measure before enabling
    (SURVEY.md §7 M5: compaction/sorting only pays off for deep,
    incoherent workloads)."""
    n = uid.shape[0]
    isect = intersect if intersect_fn is None else intersect_fn
    occl = occluded if occluded_fn is None else occluded_fn
    o, d = camera_rays(scene, uid, cfg)
    do_sort = cfg.sort_rays and scene.n_clusters > 0
    zeros1 = jnp.zeros((n,), jnp.float32)

    carry = (
        o, d,
        jnp.zeros((n, 3), jnp.float32),    # L
        jnp.ones((n, 3), jnp.float32),     # throughput
        jnp.ones((n,), bool),              # alive
        jnp.ones((n,), bool),              # prev_delta: b==0 emission gated on
        zeros1,                            # prev_pdf (solid angle)
    )
    alive_counts = []
    issued_counts = []                    # closest-hit rays actually traced
    shadow_counts = []                    # shadow rays actually traced

    for b in range(cfg.max_bounces + 1):
        step = functools.partial(_bounce_step, b=b, cfg=cfg,
                                 isect=isect, occl=occl)
        if cfg.remat:
            # scene/decision_scene/uid are explicit args so the backward
            # rematerializes from them rather than saving closure residuals
            step = jax.checkpoint(step)
        carry, (issued, n_active, n_shadow) = step(
            scene, decision_scene, uid, carry)
        issued_counts.append(issued)
        alive_counts.append(n_active)
        if n_shadow is not None:
            shadow_counts.append(n_shadow)

        if do_sort and b < cfg.max_bounces - 1:
            o, d, L, thr, alive, prev_delta, prev_pdf = carry
            perm = jnp.argsort(_coherence_key(scene, o, d, alive))
            uid, prev_pdf = uid[perm], prev_pdf[perm]
            alive, prev_delta = alive[perm], prev_delta[perm]
            o, d, thr, L = o[perm], d[perm], thr[perm], L[perm]
            carry = (o, d, L, thr, alive, prev_delta, prev_pdf)

    L = carry[2]

    if do_sort:
        L = L[jnp.argsort(uid)]  # restore uid order for the film reshape
    stats = {
        "alive": jnp.stack(alive_counts),
        # honest ray accounting (BASELINE.md protocol): closest-hit rays
        # actually traced per bounce / shadow rays actually traced per
        # bounce — the live-lane counts benchmarks report alongside the
        # flat (bounces+1)+bounces upper bound
        "rays_closest": jnp.stack(issued_counts),
        "rays_shadow": jnp.stack(shadow_counts),
    }
    return L, stats


def trace_chunked(scene, uids, cfg, decision_scene=None,
                  intersect_fn=None, occluded_fn=None):
    """Trace a flat (n,) uid array in cfg.chunk_size pieces -> (L (n,3), stats).

    The chunk loop is unrolled (static) rather than a lax.map/scan; kept
    so until the two forms are measured on the card.  n_chunks is small.
    This is also the per-device body for the sharded renderer
    (tputracer.dist): uids are global path ids, so streams are identical
    however the wavefront is split across chunks or chips.
    """
    n = uids.shape[0]
    chunk = min(cfg.chunk_size, n)
    n_chunks = -(-n // chunk)
    assert n_chunks * chunk == n, (n, chunk)
    outs = [
        trace_radiance(scene, uids[i * chunk:(i + 1) * chunk], cfg,
                       decision_scene=decision_scene,
                       intersect_fn=intersect_fn, occluded_fn=occluded_fn)
        for i in range(n_chunks)
    ]
    L = jnp.concatenate([o[0] for o in outs], axis=0)
    stats = jax.tree.map(lambda *xs: sum(xs), *[o[1] for o in outs])
    return L, stats


def render_pt(scene, cfg, decision_scene=None):
    """Full-frame render: chunked wavefront + film average.

    Returns (image (H,W,3) float32 [row 0 = top], stats).  The per-path
    -> pixel reduction is a pure reshape/mean because paths are laid out
    pixel-major and never compacted across pixels — no scatter, no
    segment_sum (SURVEY.md §7 M1).
    """
    n_total = cfg.width * cfg.height * cfg.spp
    chunk = min(cfg.chunk_size, n_total)
    n_pad = -(-n_total // chunk) * chunk
    uids = jnp.arange(n_pad, dtype=jnp.uint32)
    L, stats = trace_chunked(scene, uids, cfg,
                             decision_scene=decision_scene)
    img = film_from_radiance(L[:n_total], cfg)
    return img, stats


def film_from_radiance(L, cfg, rows=None, flip=True):
    """Per-path radiance (n,3) -> image rows, pixel-major layout.

    rows: number of image rows contained in L (defaults to full height).
    flip: camera dv points up, so uid row 0 is the BOTTOM of the image;
    flip=True returns row 0 = top.  Sharded callers that stitch row
    blocks must flip globally, not per-shard (tputracer.dist).
    """
    rows = cfg.height if rows is None else rows
    img = L.reshape(rows, cfg.width, cfg.spp, 3).mean(axis=2)
    return img[::-1] if flip else img
