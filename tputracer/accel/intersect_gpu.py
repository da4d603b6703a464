"""Fused small-scene intersection kernel for the GPU (Pallas, Triton route).

The XLA reference (accel.bruteforce) evaluates every (ray, triangle) pair
as (N, 3, T) and (N, T) arrays that go to device memory before the argmin
reduces them: memory-bound work for a test that is a few dozen FLOPs per
pair.  This kernel keeps everything in registers and writes back only
(t, prim) per ray.

Layout: one program per block of ``BLOCK`` rays, one ray per thread.  The
triangle table (24 floats a row, see ``tri_table``) is walked by a scalar
loop, so every thread reads the same row: a broadcast load that stays in
L1 for a Cornell-class scene (tens of rows).  The loop runs over the real
triangle count ``scene.n_tris``, not the padded one, and a block whose
rays are all dead (tmax <= tmin) runs no iteration.  Spheres are tested
in the same pass after the triangles.  The arithmetic is float32 on the
CUDA cores; the contraction depth (6) is too thin for the tensor cores.

Math and tie-breaking follow ``intersect_brute`` exactly: Pluecker sign
test, plane-equation t, strict ``t < best`` so the lowest primitive id
(triangles before spheres) wins an exact tie.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from tputracer.accel.bruteforce import finalize_hit
from tputracer.accel.clustered import _detach

BLOCK = 128      # rays per program: one per thread at 4 warps
NUM_WARPS = 4
TRI_COLS = 24    # plu (3 edges x [m, E]) 18, n 3, v0.n 1, mask 1, pad 1


def tri_table(scene):
    """(T, TRI_COLS) row-major triangle table in kernel layout."""
    plu = jnp.transpose(scene.plu, (2, 0, 1)).reshape(-1, 18)   # (T,18)
    v0n = jnp.sum(scene.tri_v0 * scene.tri_n, axis=-1)
    return jnp.concatenate(
        [plu, scene.tri_n, v0n[:, None], scene.tri_mask[:, None],
         jnp.zeros_like(v0n)[:, None]], axis=1)


def load_rays(o_ref, d_ref, tmin_ref, tmax_ref, start, n, block):
    """Masked loads of rays [start, start + block); rows past n come back
    dead (tmin = tmax = 0)."""
    inb = start + jnp.arange(block, dtype=jnp.int32) < n
    blk = pl.ds(start, block)
    o = tuple(plt.load(o_ref.at[blk, a], mask=inb, other=0.0)
              for a in range(3))
    d = tuple(plt.load(d_ref.at[blk, a], mask=inb, other=1.0)
              for a in range(3))
    tmin = plt.load(tmin_ref.at[blk], mask=inb, other=0.0)
    tmax = plt.load(tmax_ref.at[blk], mask=inb, other=0.0)
    return inb, o, d, tmin, tmax


def tri_test(row, o, d, m, tmin, best):
    """Pluecker inside test + plane t for one triangle row against the
    ray block.  ``row(k)`` returns column k of the triangle (a scalar or
    a per-ray gather).  Returns (t, hit) with hit already requiring
    tmin < t < best."""
    w = []
    for e in range(3):
        c = [row(6 * e + k) for k in range(6)]
        w.append(d[0] * c[0] + d[1] * c[1] + d[2] * c[2]
                 + m[0] * c[3] + m[1] * c[4] + m[2] * c[5])
    same = (((w[0] >= 0.0) & (w[1] >= 0.0) & (w[2] >= 0.0))
            | ((w[0] <= 0.0) & (w[1] <= 0.0) & (w[2] <= 0.0)))
    nx, ny, nz, v0n, msk = (row(18 + k) for k in range(5))
    dn = d[0] * nx + d[1] * ny + d[2] * nz
    on = o[0] * nx + o[1] * ny + o[2] * nz
    ok = jnp.abs(dn) > 1e-12
    t = (v0n - on) / jnp.where(ok, dn, 1.0)
    return t, same & ok & (t > tmin) & (t < best) & (msk > 0.0)


def moment(o, d):
    """o x d, the ray's Pluecker moment (as in intersect_brute)."""
    return (o[1] * d[2] - o[2] * d[1],
            o[2] * d[0] - o[0] * d[2],
            o[0] * d[1] - o[1] * d[0])


def _fused_kernel(o_ref, d_ref, tmin_ref, tmax_ref, tri_ref, sph_ref,
                  t_ref, p_ref, *, n, n_tri, n_sph):
    start = pl.program_id(0) * BLOCK
    inb, o, d, tmin, tmax = load_rays(o_ref, d_ref, tmin_ref, tmax_ref,
                                      start, n, BLOCK)
    m = moment(o, d)
    live = jnp.max((tmax > tmin).astype(jnp.int32))     # 0 or 1
    n_iter = live * n_tri

    def body(j, carry):
        bt, bp = carry
        t, hit = tri_test(lambda k: tri_ref[j, k], o, d, m, tmin, bt)
        return jnp.where(hit, t, bt), jnp.where(hit, j, bp)

    bt, bp = lax.fori_loop(0, n_iter, body,
                           (tmax, jnp.full((BLOCK,), -1, jnp.int32)))
    n_tri_pad = tri_ref.shape[0]
    for s in range(n_sph):
        cx, cy, cz, r = (sph_ref[s, a] for a in range(4))
        bx, by, bz = o[0] - cx, o[1] - cy, o[2] - cz
        b = bx * d[0] + by * d[1] + bz * d[2]
        c = bx * bx + by * by + bz * bz - r * r
        disc = b * b - c
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        t0 = -b - sq
        ts = jnp.where(t0 > tmin, t0, -b + sq)
        hit = (disc > 0.0) & (ts > tmin) & (ts < bt)
        bt = jnp.where(hit, ts, bt)
        bp = jnp.where(hit, n_tri_pad + s, bp)
    blk = pl.ds(start, BLOCK)
    plt.store(t_ref.at[blk], bt, mask=inb)
    plt.store(p_ref.at[blk], bp, mask=inb)


@functools.partial(jax.jit, static_argnames=("n_tri", "n_sph", "interpret"))
def fused_closest(o, d, tmin, tmax, tri, sph, *, n_tri, n_sph,
                  interpret=False):
    """(t, prim) of the nearest primitive per ray; t = tmax and prim = -1
    on a miss.  tri: (T, TRI_COLS) table of which the first n_tri rows
    are tested; sph: (max(S, 1), 4) [cx, cy, cz, r] of which the first
    n_sph rows are tested (sphere s has prim id T + s)."""
    n = o.shape[0]
    kernel = functools.partial(_fused_kernel, n=n, n_tri=n_tri,
                               n_sph=n_sph)
    return pl.pallas_call(
        kernel,
        grid=(pl.cdiv(n, BLOCK),),
        out_shape=[jax.ShapeDtypeStruct((n,), jnp.float32),
                   jax.ShapeDtypeStruct((n,), jnp.int32)],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name="fused_intersect",
    )(o, d, tmin, tmax, tri, sph)


def _scene_args(sc):
    sph = jnp.concatenate([sc.sph_c, sc.sph_r[:, None]], axis=1)   # (S,4)
    if not sc.n_spheres:
        sph = jnp.zeros((1, 4), jnp.float32)      # no zero-size operands
    return tri_table(sc), sph


def intersect_fused(scene, o, d, tmin, tmax, interpret=False):
    """Closest hit over all primitives (triangles + spheres) -> Hit SoA."""
    od, dd, tn, tx = _detach(o, d, tmin, tmax)
    sc = lax.stop_gradient(scene)
    t, prim = fused_closest(od, dd, tn, tx, *_scene_args(sc),
                            n_tri=scene.n_tris, n_sph=scene.n_spheres,
                            interpret=interpret)
    return finalize_hit(scene, o, d, t, prim, t < tmax)


def occluded_fused(scene, o, d, tmax, interpret=False):
    """Any-hit shadow predicate (nearest-hit form of the same kernel)."""
    o, d, tmax = _detach(o, d, tmax)
    sc = lax.stop_gradient(scene)
    tmin = jnp.zeros(o.shape[:1], jnp.float32)
    t, _ = fused_closest(o, d, tmin, tmax, *_scene_args(sc),
                         n_tri=scene.n_tris, n_sph=scene.n_spheres,
                         interpret=interpret)
    return t < tmax
