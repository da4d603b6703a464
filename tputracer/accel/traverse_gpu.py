"""Cluster-BVH traversal kernel for the GPU (Pallas, Triton route).

The same walk as the XLA reference ``clustered._traverse``, one ray per
thread.  Each ray visits the clusters its ray enters strictly front to
back by (t_enter, cluster id), and stops once its best hit is nearer than
every remaining entry (any-hit rays stop at their first hit):

  * pick: a loop over all C cluster AABBs (6 floats each, read by every
    thread alike, so they stay in L1/L2) finds the ray's next cluster —
    the smallest (t_enter, id) after the last visited one that is still
    nearer than the best hit;
  * visit: the thread gathers its own cluster's ``leaf_size`` triangle
    rows (``intersect_gpu.tri_table`` layout, cluster-major, so a
    cluster is one contiguous block of rows in L2) and runs the same
    Pluecker + plane test as ``intersect_brute``.

Nothing of size (N, C) is written to device memory: the reference's
entry matrix and per-trip triangle gathers exist only in registers.  A
block loops until its last ray is done; a ray that is done idles.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from tputracer.accel.bruteforce import finalize_hit
from tputracer.accel.clustered import _detach, _safe_inv, _sphere_best
from tputracer.accel.intersect_gpu import (load_rays, moment, tri_table,
                                           tri_test)

BLOCK = 32       # rays per program: one warp, so a block idles no longer
NUM_WARPS = 1    # than its slowest ray's own warp would
_BIG = 3.0e38    # python float: kernels may not capture jnp constants


def _traverse_kernel(o_ref, d_ref, tmin_ref, tmax_ref, bt0_ref, bp0_ref,
                     box_ref, tri_ref, t_ref, p_ref, *, n, n_clusters, leaf,
                     any_hit):
    start = pl.program_id(0) * BLOCK
    inb, o, d, tmin, tmax = load_rays(o_ref, d_ref, tmin_ref, tmax_ref,
                                      start, n, BLOCK)
    blk = pl.ds(start, BLOCK)
    bt0 = plt.load(bt0_ref.at[blk], mask=inb, other=0.0)
    bp0 = plt.load(bp0_ref.at[blk], mask=inb, other=-1)
    m = moment(o, d)
    inv = tuple(_safe_inv(x) for x in d)

    def pick(best_t, t_last, c_last):
        """Next cluster per ray: smallest (t_enter, id) > (t_last,
        c_last) with t_enter < best_t; (_BIG, -1) when none is left."""
        def scan(c, carry):
            t_next, c_next = carry
            tn, tf = None, None
            for a in range(3):
                t0 = (box_ref[c, a] - o[a]) * inv[a]
                t1 = (box_ref[c, 3 + a] - o[a]) * inv[a]
                lo, hi = jnp.minimum(t0, t1), jnp.maximum(t0, t1)
                tn = lo if tn is None else jnp.maximum(tn, lo)
                tf = hi if tf is None else jnp.minimum(tf, hi)
            te = jnp.maximum(tn, tmin)
            hit = (tn <= tf) & (tf > tmin) & (tn < tmax)
            after = (te > t_last) | ((te == t_last) & (c > c_last))
            better = hit & after & (te < best_t) & (te < t_next)
            return jnp.where(better, te, t_next), jnp.where(better, c, c_next)

        return lax.fori_loop(0, n_clusters, scan,
                             (jnp.full((BLOCK,), _BIG, jnp.float32),
                              jnp.full((BLOCK,), -1, jnp.int32)))

    def visit(cid, active, best_t, best_p):
        """Test cluster cid's triangles for the active rays."""
        base = jnp.where(active, cid, 0) * leaf

        def tri(j, carry):
            bt, bp = carry
            row = base + j
            t, hit = tri_test(
                lambda k: plt.load(tri_ref.at[row, k], mask=active,
                                   other=0.0),
                o, d, m, tmin, bt)
            hit = hit & active
            return jnp.where(hit, t, bt), jnp.where(hit, row, bp)

        return lax.fori_loop(0, leaf, tri, (best_t, best_p))

    def cond(carry):
        return jnp.max(jnp.where(carry[-1], 1, 0)) > 0

    def body(carry):
        best_t, best_p, t_last, c_last, live = carry
        t_next, c_next = pick(best_t, t_last, c_last)
        active = live & (c_next >= 0)
        bt, bp = visit(c_next, active, best_t, best_p)
        improved = bt < best_t
        live = active & jnp.logical_not(improved) if any_hit else active
        return (bt, bp, jnp.where(active, t_next, t_last),
                jnp.where(active, c_next, c_last), live)

    init = (jnp.minimum(bt0, tmax), bp0,
            jnp.full((BLOCK,), -_BIG, jnp.float32),
            jnp.full((BLOCK,), -1, jnp.int32), tmax > tmin)
    best_t, best_p, *_ = lax.while_loop(cond, body, init)
    plt.store(t_ref.at[blk], best_t, mask=inb)
    plt.store(p_ref.at[blk], best_p, mask=inb)


@functools.partial(jax.jit,
                   static_argnames=("leaf", "any_hit", "interpret"))
def traverse(o, d, tmin, tmax, bt0, bp0, boxes, tri, *, leaf,
             any_hit=False, interpret=False):
    """(t, prim) per ray through the cluster BVH, starting from the best
    hit (bt0, bp0) found so far.  boxes: (C, 6) [min xyz, max xyz];
    tri: (C * leaf, TRI_COLS) cluster-major triangle table.  On a miss
    t = min(bt0, tmax) and prim = bp0."""
    n = o.shape[0]
    kernel = functools.partial(_traverse_kernel, n=n,
                               n_clusters=boxes.shape[0], leaf=leaf,
                               any_hit=any_hit)
    return pl.pallas_call(
        kernel,
        grid=(pl.cdiv(n, BLOCK),),
        out_shape=[jax.ShapeDtypeStruct((n,), jnp.float32),
                   jax.ShapeDtypeStruct((n,), jnp.int32)],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name="cluster_traverse",
    )(o, d, tmin, tmax, bt0, bp0, boxes, tri)


def scene_tables(sc):
    """(boxes (C, 6), triangle table) of a clustered scene."""
    return (jnp.concatenate([sc.clus_min, sc.clus_max], axis=1),
            tri_table(sc))


def traverse_scene(sc, o, d, tmin, tmax, bt0, bp0, *, any_hit,
                   interpret=False):
    """``traverse`` on a (detached) clustered scene."""
    return traverse(o, d, tmin, tmax, bt0, bp0, *scene_tables(sc),
                    leaf=sc.leaf_size, any_hit=any_hit, interpret=interpret)


def intersect_traverse(scene, o, d, tmin, tmax, interpret=False):
    """Closest hit through the cluster BVH -> Hit SoA."""
    od, dd, tn, tx = _detach(o, d, tmin, tmax)
    sc = lax.stop_gradient(scene)
    bt0, bp0 = _sphere_best(sc, od, dd, tn, tx)
    t, prim = traverse_scene(sc, od, dd, tn, tx, bt0, bp0, any_hit=False,
                             interpret=interpret)
    return finalize_hit(scene, o, d, t, prim, t < tmax)


def occluded_traverse(scene, o, d, tmax, interpret=False):
    """Any-hit shadow predicate through the cluster BVH."""
    o, d, tmax = _detach(o, d, tmax)
    sc = lax.stop_gradient(scene)
    tmin = jnp.zeros(o.shape[:1], jnp.float32)
    bt0, _ = _sphere_best(sc, o, d, tmin, tmax)
    t, _ = traverse_scene(sc, o, d, tmin, tmax, bt0,
                          jnp.full(o.shape[:1], -1, jnp.int32),
                          any_hit=True, interpret=interpret)
    return t < tmax
