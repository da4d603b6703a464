"""Cluster-BVH traversal in pure XLA (SURVEY.md §2 row 6, §3.5 redesign).

The reference walks a KD-tree recursively per ray, ordering children
near/far and clipping the t-interval (SURVEY.md §3.5).  This XLA form
keeps the same *front-to-back, early-out* semantics with dense arrays
over the whole ray batch:

  1. every ray slab-tests ALL cluster AABBs densely (one fused pass —
     C is a few hundred to a few thousand, so this replaces the tree's
     upper levels outright);
  2. a ``lax.while_loop`` then visits each ray's intersected clusters in
     strictly increasing entry-distance order (lexicographic (t_enter,
     cluster-id) keys — the vectorized analogue of the reference's
     near-child-first descent).  Per visit, the ray tests the cluster's
     ``leaf_size`` triangles as one contiguous block gather + dense
     Pluecker/plane evaluation;
  3. a ray stops as soon as its best hit is nearer than every remaining
     cluster entry (the reference's "early-out when hit.t < tmin" in
     batch form): its lane goes inactive and the loop ends when all lanes
     are done.

This file is the plain-XLA path (SURVEY.md §7 hard-part 1), used on the
CPU, and the oracle for the GPU kernel (accel.traverse_gpu), which walks
the same order one ray per thread; both are tested against brute force.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from tputracer.accel.bruteforce import (
    _sph_candidates,
    finalize_hit,
)

_BIG = 3.0e38  # python float — see accel/bruteforce.py note


def _safe_inv(d):
    """1/d with signed clamp — degenerate axes produce +-inf slabs, which
    the min/max slab arithmetic handles correctly (IEEE semantics).
    Python-float constants, so the traversal kernel can use it too."""
    return 1.0 / jnp.where(jnp.abs(d) < 1e-12,
                           jnp.where(d >= 0.0, 1e-12, -1e-12), d)


def cluster_entries(scene, o, d, tmin, tmax):
    """(N, C) cluster entry distances; _BIG where the ray misses the AABB."""
    inv = _safe_inv(d)
    t0 = (scene.clus_min[None, :, :] - o[:, None, :]) * inv[:, None, :]
    t1 = (scene.clus_max[None, :, :] - o[:, None, :]) * inv[:, None, :]
    tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
    hit = (tn <= tf) & (tf > tmin[:, None]) & (tn < tmax[:, None])
    return jnp.where(hit, jnp.maximum(tn, tmin[:, None]), _BIG)


def _tri_block(scene, feat, o, d, cid):
    """Gather cluster cid's triangle block and evaluate the Pluecker +
    plane tests for every (ray, block-triangle) pair.

    feat: (N,6) ray feature [d, o x d];  cid: (N,) int32.
    Returns (t (N,L), geo_ok (N,L)) — geometric hit before interval tests.
    """
    C, L = scene.n_clusters, scene.leaf_size
    plu = jnp.take(scene.plu.reshape(3, 6, C, L), cid, axis=2)  # (3,6,N,L)
    w = jnp.einsum("nk,jknl->njl", feat, plu,
                   precision=lax.Precision.HIGHEST)             # (N,3,L)
    same_sign = jnp.logical_or(
        jnp.all(w >= 0.0, axis=1), jnp.all(w <= 0.0, axis=1))   # (N,L)

    nj = jnp.take(scene.tri_n.reshape(C, L, 3), cid, axis=0)    # (N,L,3)
    v0n = jnp.take(
        jnp.sum(scene.tri_v0 * scene.tri_n, axis=-1).reshape(C, L),
        cid, axis=0)                                            # (N,L)
    mask = jnp.take(scene.tri_mask.reshape(C, L), cid, axis=0)  # (N,L)
    d_dot = jnp.einsum("nk,nlk->nl", d, nj,
                       precision=lax.Precision.HIGHEST)
    o_dot = jnp.einsum("nk,nlk->nl", o, nj,
                       precision=lax.Precision.HIGHEST)
    denom_ok = jnp.abs(d_dot) > 1e-12
    t = (v0n - o_dot) / jnp.where(denom_ok, d_dot, 1.0)
    return t, same_sign & denom_ok & (mask > 0.0)


def _traverse(scene, o, d, tmin, tmax, best_t0, best_prim0, any_hit):
    """Shared front-to-back cluster walk.  any_hit=True short-circuits
    lanes at the first occluder (shadow rays); False keeps the nearest."""
    n = o.shape[0]
    L = scene.leaf_size
    te = cluster_entries(scene, o, d, tmin, tmax)        # (N,C)
    iota_c = jnp.arange(scene.n_clusters, dtype=jnp.int32)[None, :]
    feat = jnp.concatenate([d, jnp.cross(o, d)], axis=-1)

    def cond(carry):
        return carry[-1]

    def body(carry):
        best_t, best_prim, t_last, c_last, _ = carry
        # next unvisited cluster per ray, front-to-back: strictly greater
        # (t_enter, cluster-id) than the last visited, entered before the
        # current best hit (the early-out of SURVEY.md §3.5)
        elig = (te > t_last[:, None]) | (
            (te == t_last[:, None]) & (iota_c > c_last[:, None]))
        useful = elig & (te < best_t[:, None])
        score = jnp.where(useful, te, _BIG)
        t_next = jnp.min(score, axis=1)
        active = t_next < _BIG
        cid = jnp.argmax(score == t_next[:, None], axis=1).astype(jnp.int32)

        t_blk, ok = _tri_block(scene, feat, o, d, cid)
        ok = ok & (t_blk > tmin[:, None]) & (t_blk < best_t[:, None]) \
            & active[:, None]
        t_blk = jnp.where(ok, t_blk, _BIG)
        j = jnp.argmin(t_blk, axis=1).astype(jnp.int32)
        t_hit = jnp.take_along_axis(t_blk, j[:, None], axis=1)[:, 0]
        improve = active & (t_hit < best_t)
        best_t = jnp.where(improve, t_hit, best_t)
        best_prim = jnp.where(improve, cid * L + j, best_prim)
        t_last = jnp.where(active, t_next, t_last)
        c_last = jnp.where(active, cid, c_last)
        go = active & jnp.logical_not(improve) if any_hit else active
        return best_t, best_prim, t_last, c_last, jnp.any(go)

    init = (best_t0, best_prim0,
            jnp.full((n,), -_BIG), jnp.full((n,), -1, jnp.int32),
            jnp.array(True))
    best_t, best_prim, *_ = lax.while_loop(cond, body, init)
    return best_t, best_prim


def _sphere_best(scene, o, d, tmin, tmax):
    """Nearest sphere hit as the traversal's initial best (S is tiny)."""
    n = o.shape[0]
    if not scene.n_spheres:
        return jnp.full((n,), _BIG), jnp.full((n,), -1, jnp.int32)
    ts, sv = _sph_candidates(scene, o, d, tmin, tmax)
    ts = jnp.where(sv, ts, _BIG)
    j = jnp.argmin(ts, axis=1).astype(jnp.int32)
    t = jnp.take_along_axis(ts, j[:, None], axis=1)[:, 0]
    prim = jnp.where(t < _BIG, scene.n_tri_pad + j, -1)
    return t, prim


def _detach(*xs):
    """Traversal is wrapped in stop_gradient: (t, prim) depend only on
    geometry, never on the differentiable material/light tables, so
    detaching is exact — and it keeps jax.grad away from the
    lax.while_loop, which has no reverse rule (SURVEY.md §3.6: traversal
    is non-differentiable by construction)."""
    return tuple(lax.stop_gradient(x) for x in xs)


def intersect_clustered(scene, o, d, tmin, tmax):
    """Closest hit through the cluster BVH; same Hit SoA as brute force."""
    od, dd, tn, tx = _detach(o, d, tmin, tmax)
    sc = lax.stop_gradient(scene)
    bt0, bp0 = _sphere_best(sc, od, dd, tn, tx)
    bt0 = jnp.minimum(bt0, tx)
    t, prim = _traverse(sc, od, dd, tn, tx, bt0, bp0, any_hit=False)
    return finalize_hit(scene, o, d, t, prim, t < tmax)


def occluded_clustered(scene, o, d, tmax):
    """Any-hit predicate for shadow rays through the cluster BVH."""
    o, d, tmax = _detach(o, d, tmax)
    scene = lax.stop_gradient(scene)
    tmin = jnp.zeros(o.shape[:1], jnp.float32)
    bt0, _ = _sphere_best(scene, o, d, tmin, tmax)
    occ0 = bt0 < tmax
    t, _ = _traverse(scene, o, d, tmin, tmax,
                     jnp.where(occ0, bt0, tmax),
                     jnp.full(o.shape[:1], -1, jnp.int32), any_hit=True)
    return occ0 | (t < tmax)
