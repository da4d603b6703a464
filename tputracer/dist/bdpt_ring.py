"""Ring-style BDPT vertex connection over the device mesh (SURVEY.md §2
"SP/ring" row, §5 "long-context analogue").

DP BDPT (dist.mesh.render_bdpt_sharded) pairs each eye subpath with its
own light subpath — no cross-shard traffic, but every eye path sees ONE
light subpath.  The ring renderer shards light subpaths with the rays
and **rotates the light-vertex blocks around a device ring** with
``lax.ppermute`` (the ring-attention communication pattern): after P
steps every eye subpath has connected against P independent light
subpaths, at constant per-device memory and with each exchange
overlappable with the connection einsums.

Estimator: the (s>=1, t>=2) connection strategies average over the P
light-subpath partners (each an unbiased sample of the same integrals);
the s=0 strategies depend only on the eye walk and the t=1 splats only
on the local light walk, so both run once.  MIS weights are per
(eye, light) pair and unchanged.  Relative to plain BDPT this is the
same integral estimated with P connection samples per eye path — lower
connection variance for ~zero extra subpath work.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import PartitionSpec as P
from jax import shard_map

from tputracer.integrators.bdpt import (
    connection_radiance,
    eye_subpaths,
    light_subpaths,
    s0_radiance,
    t1_splats,
)
from tputracer.integrators.pt import film_from_radiance


def ring_bdpt_radiance(scene, uids, cfg, axes, n_shards):
    """Per-shard BDPT radiance with ring-rotated light-subpath blocks.

    Runs INSIDE a shard_map over `axes`.  Returns (L_own (n,3), splat
    (H*W,3) — local, caller psums the splat film).
    """
    zs = eye_subpaths(scene, uids, cfg)
    ys = light_subpaths(scene, uids, cfg)
    L = s0_radiance(scene, cfg, zs)
    splat = t1_splats(scene, cfg, ys, zs)
    perm = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    conn = jnp.zeros_like(L)
    ys_r = ys
    for r in range(n_shards):
        if r > 0:
            # tuple axis name = linearized multi-axis ring (row-major),
            # so the same code serves (dp,) and (host, chip) meshes
            ys_r = jax.tree.map(
                lambda x: lax.ppermute(x, tuple(axes), perm), ys_r)
        conn = conn + connection_radiance(scene, cfg, ys_r, zs)
    return L + conn / jnp.float32(n_shards), splat


def emulate_ring_bdpt(scene, uids, cfg, n_shards):
    """Single-device emulation of the P-shard ring estimator: light
    blocks roll by whole shards.  The oracle for the sharded path (and a
    valid single-device many-light-subpath BDPT in its own right)."""
    n = uids.shape[0]
    n_loc = n // n_shards
    assert n_loc * n_shards == n
    zs = eye_subpaths(scene, uids, cfg)
    ys = light_subpaths(scene, uids, cfg)
    L = s0_radiance(scene, cfg, zs)
    splat = t1_splats(scene, cfg, ys, zs)
    conn = jnp.zeros_like(L)
    for r in range(n_shards):
        # after r ppermute steps, shard p holds the light block of shard
        # (p - r) mod P: a roll of +r blocks along the path axis
        ys_r = jax.tree.map(
            lambda x: jnp.roll(x, r * n_loc, axis=0), ys)
        conn = conn + connection_radiance(scene, cfg, ys_r, zs)
    return L + conn / jnp.float32(n_shards), splat


@partial(jax.jit, static_argnums=(1, 2))
def _render_bdpt_ring_jit(scene, cfg, mesh):
    axes = mesh.axis_names
    n_shards = int(np.prod(mesh.devices.shape))
    rows_per = cfg.height // n_shards
    if rows_per * n_shards != cfg.height:
        raise ValueError("height must divide the mesh size")
    n_total = cfg.width * cfg.height * cfg.spp

    def shard_body(scene, uids):
        L_own, splat = ring_bdpt_radiance(scene, uids, cfg, axes, n_shards)
        img = film_from_radiance(L_own, cfg, rows=rows_per, flip=False)
        splat = lax.psum(splat, axes)
        i = jnp.int32(0)
        for ax in axes:
            i = i * lax.axis_size(ax) + lax.axis_index(ax)
        rows = lax.dynamic_slice(
            splat.reshape(cfg.height, cfg.width, 3),
            (i * rows_per, 0, 0), (rows_per, cfg.width, 3))
        return img + rows / jnp.float32(n_total)

    uids = jnp.arange(n_total, dtype=jnp.uint32)
    f = shard_map(
        shard_body,
        mesh=mesh,
        check_vma=False,
        in_specs=(jax.tree.map(lambda _: P(), scene), P(axes)),
        out_specs=P(axes),
    )
    return f(scene, uids)[::-1]


def render_bdpt_ring(scene, cfg, mesh):
    """Full-frame ring-connection BDPT render over the mesh -> (H,W,3).

    Each eye subpath connects against P light subpaths (its own + P-1
    ppermute-rotated partner blocks); converges to the same image as
    render_bdpt with ~1/P the connection variance."""
    return _render_bdpt_ring_jit(scene, cfg, mesh)
