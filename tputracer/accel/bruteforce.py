"""Batched brute-force intersection (SURVEY.md §2 rows 3-4, M1 of §7).

The reference does per-ray Moeller-Trumbore in a recursive KD-tree walk
(SURVEY.md §3.5).  For Cornell-class scenes (tens of primitives) the
fastest structure is NO structure — test every ray against every
primitive:

  * ray feature  f = [d, o x d]                    (N, 6)
  * per-edge Pluecker coordinates  [M, E]          (6, T) x 3 edges
  * signed volumes  w = f . [M, E]                 (N, 3, T)
  * hit  <=>  all three w same sign;  t from the plane equation.

No branches, no divergence, no acceleration-structure memory traffic.
This is the XLA reference; on the GPU accel.intersect_gpu runs the same
test as one fused kernel.  The cluster BVH (accel.bvh) takes over for
~100k-triangle scenes with the same leaf test.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from tputracer import geometry as g

_BIG = 3.0e38  # python float, NOT jnp.float32: module-level jnp
               # constants get hoisted as phantom executable inputs
               # when traced after another jit has run (jax 0.9 bug:
               # 'supplied N buffers but expected N+3')


class Hit(NamedTuple):
    """SoA hit record over a wavefront of N rays."""

    t: jnp.ndarray       # (N,)  hit distance; _BIG on miss
    prim: jnp.ndarray    # (N,)  int32 primitive id (tris: [0,Tp), spheres: Tp+i); -1 miss
    valid: jnp.ndarray   # (N,)  bool
    p: jnp.ndarray       # (N,3) hit point
    n: jnp.ndarray       # (N,3) outward unit geometric normal (by winding)
    mat: jnp.ndarray     # (N,)  int32 material id (0 on miss)


def _tri_candidates(scene, o, d, tmin, tmax):
    """(t, valid) per (ray, triangle): the Pluecker sign test + plane t.

    Written elementwise (no dot products), so XLA fuses the whole (N, T)
    evaluation into the reduction that consumes it instead of writing
    (N, 3, T) and (N, T) planes to memory; the GPU kernels sum in the
    same order."""
    m = jnp.cross(o, d)                              # (N,3) ray moment
    feat = jnp.concatenate([d, m], axis=-1)          # (N,6)
    plu = scene.plu                                  # (3,6,T)
    # signed volumes against the three edges of every triangle
    w = [sum(feat[:, k, None] * plu[e, k][None, :] for k in range(6))
         for e in range(3)]                          # 3 x (N,T)
    same_sign = (((w[0] >= 0.0) & (w[1] >= 0.0) & (w[2] >= 0.0))
                 | ((w[0] <= 0.0) & (w[1] <= 0.0) & (w[2] <= 0.0)))

    # t from the supporting plane:  t = (v0.n - o.n) / (d.n)
    nj = scene.tri_n                                  # (T,3)
    d_dot_n = sum(d[:, k, None] * nj[None, :, k] for k in range(3))
    o_dot_n = sum(o[:, k, None] * nj[None, :, k] for k in range(3))
    v0_dot_n = jnp.sum(scene.tri_v0 * nj, axis=-1)    # (T,)
    denom_ok = jnp.abs(d_dot_n) > 1e-12
    t = (v0_dot_n[None, :] - o_dot_n) / jnp.where(denom_ok, d_dot_n, 1.0)

    valid = (
        same_sign
        & denom_ok
        & (t > tmin[:, None])
        & (t < tmax[:, None])
        & (scene.tri_mask[None, :] > 0.0)
    )
    return t, valid


def _sph_candidates(scene, o, d, tmin, tmax):
    """(t, valid) per (ray, sphere): stable quadratic (SURVEY.md §2 row 4)."""
    oc = o[:, None, :] - scene.sph_c[None, :, :]      # (N,S,3)
    b = jnp.sum(oc * d[:, None, :], axis=-1)          # (N,S)
    c = jnp.sum(oc * oc, axis=-1) - scene.sph_r[None, :] ** 2
    disc = b * b - c
    ok = disc > 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t0 = -b - sq
    t1 = -b + sq
    t = jnp.where(t0 > tmin[:, None], t0, t1)
    valid = ok & (t > tmin[:, None]) & (t < tmax[:, None])
    return t, valid


def intersect_brute(scene, o, d, tmin, tmax) -> Hit:
    """Closest-hit over all primitives: masked argmin over the (N, T+S) t-matrix."""
    tt, tv = _tri_candidates(scene, o, d, tmin, tmax)
    t_all = jnp.where(tv, tt, _BIG)
    if scene.n_spheres:
        ts, sv = _sph_candidates(scene, o, d, tmin, tmax)
        t_all = jnp.concatenate([t_all, jnp.where(sv, ts, _BIG)], axis=1)

    # two reductions of one fused producer: t_all never goes to memory
    prim = jnp.argmin(t_all, axis=1).astype(jnp.int32)   # (N,)
    t = jnp.min(t_all, axis=1)
    valid = t < tmax
    return finalize_hit(scene, o, d, t, prim, valid)


def finalize_hit(scene, o, d, t, prim, valid) -> Hit:
    """Assemble the Hit SoA from (t, prim, valid) — shared by all
    intersectors (brute force, clustered XLA, Pallas)."""
    Tp = scene.n_tri_pad
    is_tri = prim < Tp
    # missed lanes keep t=_BIG for the valid test, but the hit POINT uses
    # a clamped t: o + 3e38*d overflows dot(p,p) to inf, and that inf
    # poisons gradients through the (masked) NEE math downstream
    p = o + jnp.where(valid, t, 1.0)[:, None] * d
    tri_id = jnp.where(is_tri, prim, 0)
    n_tri = g.normalize(scene.tri_n[tri_id])
    if scene.n_spheres:
        sph_id = jnp.where(is_tri, 0, prim - Tp)
        n_sph = (p - scene.sph_c[sph_id]) / scene.sph_r[sph_id][:, None]
        n = jnp.where(is_tri[:, None], n_tri, n_sph)
        mat = jnp.where(is_tri, scene.tri_mat[tri_id],
                        scene.sph_mat[sph_id])
    else:
        n = n_tri
        mat = scene.tri_mat[tri_id]

    return Hit(
        t=t,
        prim=jnp.where(valid, prim, -1),
        valid=valid,
        p=p,
        n=n,
        mat=jnp.where(valid, mat, 0),
    )


def occluded_brute(scene, o, d, tmax):
    """Any-hit predicate for shadow rays — no argmin, no gathers."""
    tmin = jnp.full(o.shape[:1], jnp.float32(0.0))
    _, tv = _tri_candidates(scene, o, d, tmin, tmax)
    occ = jnp.any(tv, axis=1)
    if scene.n_spheres:
        _, sv = _sph_candidates(scene, o, d, tmin, tmax)
        occ = occ | jnp.any(sv, axis=1)
    return occ
