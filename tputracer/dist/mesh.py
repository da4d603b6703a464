"""Multi-device / multi-host rendering (SURVEY.md §2 parallelism table,
§7 M7).

The reference is a single CPU process with no distribution layer; this
module is the new framework's scaling story:

  * **DP over rays** — the wavefront's path axis is sharded across every
    device of a ``jax.sharding.Mesh`` via ``shard_map``.  Path uids are
    global and the RNG is counter-based on uid (tputracer.rng), so the
    rendered image is placement-invariant: 1 device or 8 produce the
    same film (SURVEY.md §4.5).
  * **Scene replicated** — Cornell-class scenes are a few KB; every leaf
    is broadcast (in_spec ``P()``).  Scene *tiling* (the TP analogue,
    dist.scene_shard) is for scenes that outgrow one device's memory.
  * **Gradient psum** — inverse rendering reduces parameter gradients
    with one ``psum`` over all mesh axes inside the shard_map (the
    all-reduce of SURVEY.md §2's "Gradient reduction" row).

The default mesh is one ``"dp"`` axis: every GPU of a host reaches every
other at the same rate, so the mesh follows the algorithm.  Rays shard
over *all* axes of a mesh jointly and collectives reduce over all axes,
so a multi-axis mesh (named by the caller) runs the same code.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from tputracer.integrators.pt import film_from_radiance, trace_chunked


def make_mesh(shape=None, axis_names=None, devices=None):
    """Build a Mesh over the available devices.

    shape: tuple of axis sizes (default: all devices on one "dp" axis);
    a multi-axis shape needs its axis_names.
    """
    devices = devices if devices is not None else jax.devices()
    if shape is None:
        shape = (len(devices),)
    if axis_names is None:
        if len(shape) != 1:
            raise ValueError(f"mesh shape {shape} needs axis_names")
        axis_names = ("dp",)
    n = int(np.prod(shape))
    arr = np.array(devices[:n]).reshape(shape)
    return Mesh(arr, axis_names)


def _replicated(tree):
    return jax.tree.map(lambda _: P(), tree)


def _check_divisible(cfg, n_shards):
    rows_per = cfg.height // n_shards
    if rows_per * n_shards != cfg.height:
        raise ValueError(
            f"height {cfg.height} must divide by the mesh size {n_shards} "
            "(rays are sharded in whole image rows)"
        )
    return rows_per


@partial(jax.jit, static_argnums=(1, 2))
def _render_sharded_jit(scene, cfg, mesh):
    axes = mesh.axis_names
    n_shards = int(np.prod(mesh.devices.shape))
    rows_per = _check_divisible(cfg, n_shards)
    n_total = cfg.width * cfg.height * cfg.spp

    def shard_body(scene, uids):
        L, stats = trace_chunked(scene, uids, cfg)
        img = film_from_radiance(L, cfg, rows=rows_per, flip=False)
        # stats match api.render's single-device contract: per-bounce
        # counts are global sums, not per-shard concatenations
        stats = jax.tree.map(lambda x: jax.lax.psum(x, axes), stats)
        return img, stats

    uids = jnp.arange(n_total, dtype=jnp.uint32)
    f = shard_map(
        shard_body,
        mesh=mesh,
        check_vma=False,  # pallas_call outputs carry no vma metadata
        in_specs=(_replicated(scene), P(axes)),
        out_specs=(P(axes), P()),
    )
    img, stats = f(scene, uids)
    return img[::-1], stats  # global flip: row 0 = top


def render_sharded(scene, cfg, mesh):
    """Full-frame render sharded over the mesh. Returns (image, stats).

    Bitwise-identical to api.render for any mesh shape (pixel-keyed RNG).
    """
    return _render_sharded_jit(scene, cfg, mesh)


def own_splat_rows(splat, cfg, axes, rows_per):
    """psum the global t=1 splat film over the mesh and return THIS
    shard's row block (round-5 dedup: shared by the DP render, the DP
    fit loss and the tiled BDPT render).  The backward through the psum
    is the cross-shard cotangent sum the splat coupling needs
    (tests/distributed/test_sharded_bdpt_fit.py)."""
    splat = jax.lax.psum(splat, axes)
    i = jnp.int32(0)
    for ax in axes:
        i = i * jax.lax.axis_size(ax) + jax.lax.axis_index(ax)
    return jax.lax.dynamic_slice(
        splat.reshape(cfg.height, cfg.width, 3),
        (i * rows_per, 0, 0), (rows_per, cfg.width, 3))


@partial(jax.jit, static_argnums=(1, 2))
def _render_bdpt_sharded_jit(scene, cfg, mesh):
    from tputracer.integrators.bdpt import trace_bdpt_rows

    axes = mesh.axis_names
    n_shards = int(np.prod(mesh.devices.shape))
    rows_per = _check_divisible(cfg, n_shards)
    n_total = cfg.width * cfg.height * cfg.spp

    def shard_body(scene, uids):
        L_own, splat, _ = trace_bdpt_rows(scene, uids, cfg)
        img = film_from_radiance(L_own, cfg, rows=rows_per, flip=False)
        # t=1 splats land on ARBITRARY pixels: all-reduce, keep own rows
        rows = own_splat_rows(splat, cfg, axes, rows_per)
        return img + rows / jnp.float32(n_total)

    uids = jnp.arange(n_total, dtype=jnp.uint32)
    f = shard_map(
        shard_body,
        mesh=mesh,
        check_vma=False,  # pallas_call outputs carry no vma metadata
        in_specs=(_replicated(scene), P(axes)),
        out_specs=P(axes),
    )
    return f(scene, uids)[::-1]  # global flip: row 0 = top


def render_bdpt_sharded(scene, cfg, mesh):
    """Full-frame BDPT render sharded over the mesh (rays DP over rows;
    light-tracing splat film psum over the mesh).  Matches api.render_bdpt up
    to float reduction order in the splat sum."""
    return _render_bdpt_sharded_jit(scene, cfg, mesh)


@partial(jax.jit, static_argnums=(3, 4))
def _fit_step_bdpt_jit(scene, params, target, cfg, mesh):
    from tputracer.integrators.bdpt import trace_bdpt_rows

    axes = mesh.axis_names
    n_shards = int(np.prod(mesh.devices.shape))
    rows_per = _check_divisible(cfg, n_shards)
    n_total = cfg.width * cfg.height * cfg.spp
    denom = jnp.float32(cfg.height * cfg.width * 3)

    def shard_loss(scene, params, uids, tgt_rows):
        def loss_fn(p):
            sc = scene.replace(**p)
            L_own, splat, _ = trace_bdpt_rows(sc, uids, cfg)
            img = film_from_radiance(L_own, cfg, rows=rows_per, flip=False)
            # the t=1 splat film couples shards; the backward flows
            # THROUGH the psum inside own_splat_rows (see its docstring)
            img = img + own_splat_rows(splat, cfg, axes,
                                       rows_per) / jnp.float32(n_total)
            return jnp.sum((img - tgt_rows) ** 2) / denom

        loss, grads = jax.value_and_grad(loss_fn)(params)
        loss = jax.lax.psum(loss, axes)
        grads = jax.lax.psum(grads, axes)
        return loss, grads

    uids = jnp.arange(n_total, dtype=jnp.uint32)
    f = shard_map(
        shard_loss,
        mesh=mesh,
        check_vma=False,
        in_specs=(_replicated(scene), _replicated(params), P(axes), P(axes)),
        out_specs=(P(), _replicated(params)),
    )
    return f(scene, params, uids, target[::-1])


def fit_step_bdpt_sharded(scene, params, target, cfg, mesh):
    """One inverse-rendering step with the BIDIRECTIONAL integrator,
    rays DP-sharded over the mesh (round-5: closes the 'BDPT fit is
    single-device' scope note with code).  cfg is a BdptConfig; returns
    (loss, grads), grads psum-ed over every mesh axis.  Matches the
    single-device BDPT loss/grads to float tolerance."""
    return _fit_step_bdpt_jit(scene, params, target, cfg, mesh)


@partial(jax.jit, static_argnums=(3, 4, 5, 7))
def _fit_chain_bdpt_jit(scene, params, target, cfg, mesh, opt, opt_state,
                        n_steps):
    from tputracer.fit import chain_steps

    return chain_steps(
        lambda sc, p, t: _fit_step_bdpt_jit(sc, p, t, cfg, mesh),
        scene, params, target, opt, opt_state, n_steps)


def fit_chain_bdpt_sharded(scene, params, target, cfg, mesh, opt,
                           opt_state, n_steps):
    """n_steps fused BDPT optimization steps in ONE dispatch (see
    fit_chain_sharded)."""
    return _fit_chain_bdpt_jit(scene, params, target, cfg, mesh, opt,
                               opt_state, n_steps)


@partial(jax.jit, static_argnums=(3, 4))
def _fit_step_jit(scene, params, target, cfg, mesh):
    axes = mesh.axis_names
    n_shards = int(np.prod(mesh.devices.shape))
    rows_per = _check_divisible(cfg, n_shards)
    n_total = cfg.width * cfg.height * cfg.spp
    denom = jnp.float32(cfg.height * cfg.width * 3)

    def shard_loss(scene, params, uids, tgt_rows):
        # per-device partial loss; global loss = psum over all mesh axes
        def loss_fn(p):
            sc = scene.replace(**p)
            L, _ = trace_chunked(sc, uids, cfg)
            img = film_from_radiance(L, cfg, rows=rows_per, flip=False)
            return jnp.sum((img - tgt_rows) ** 2) / denom

        loss, grads = jax.value_and_grad(loss_fn)(params)
        loss = jax.lax.psum(loss, axes)
        # explicit grad all-reduce (SURVEY.md §2 "Gradient reduction"):
        # with check_vma=True shard_map would insert this psum itself as
        # the transpose of the implicit param pbroadcast, but check_vma
        # is off (pallas_call outputs carry no vma metadata), so the
        # unchecked mode returns per-shard partials and the reduction is
        # ours to place.  XLA still overlaps it with the backward sweep.
        grads = jax.lax.psum(grads, axes)
        return loss, grads

    uids = jnp.arange(n_total, dtype=jnp.uint32)
    f = shard_map(
        shard_loss,
        mesh=mesh,
        check_vma=False,  # pallas_call outputs carry no vma metadata
        in_specs=(_replicated(scene), _replicated(params), P(axes), P(axes)),
        out_specs=(P(), _replicated(params)),
    )
    # target rows in uid order = bottom-up: flip the top-down target once
    return f(scene, params, uids, target[::-1])


def fit_step_sharded(scene, params, target, cfg, mesh):
    """One inverse-rendering step on the mesh: (loss, grads), grads psum-ed.

    params: dict of Scene field overrides (e.g. mat_albedo, mat_emission).
    target: (H,W,3) top-down target image (replicated; rows are consumed
    per-shard, flipped internally to match uid order).
    """
    return _fit_step_jit(scene, params, target, cfg, mesh)


@partial(jax.jit, static_argnums=(3, 4, 5))
def _fit_step_opt_jit(scene, params, target, cfg, mesh, opt, opt_state):
    import optax

    from tputracer.fit import _project

    # nested jit inlines: the whole step compiles to one program
    loss, grads = _fit_step_jit(scene, params, target, cfg, mesh)
    updates, opt_state = opt.update(grads, opt_state, params)
    params = _project(optax.apply_updates(params, updates))
    return loss, params, opt_state


def fit_step_opt_sharded(scene, params, target, cfg, mesh, opt, opt_state):
    """Fully-fused optimization step: render + backward + grad psum +
    optimizer update + projection in ONE jit program.

    One dispatch per step instead of one jit plus dozens of op-by-op
    optax dispatches.  Returns (loss, new_params, new_opt_state).
    """
    return _fit_step_opt_jit(scene, params, target, cfg, mesh, opt,
                             opt_state)


@partial(jax.jit, static_argnums=(3, 4, 5, 7))
def _fit_chain_jit(scene, params, target, cfg, mesh, opt, opt_state,
                   n_steps):
    from tputracer.fit import chain_steps

    return chain_steps(
        lambda sc, p, t: _fit_step_jit(sc, p, t, cfg, mesh),
        scene, params, target, opt, opt_state, n_steps)


def fit_chain_sharded(scene, params, target, cfg, mesh, opt, opt_state,
                      n_steps):
    """n_steps fused optimization steps in ONE jit dispatch.

    An optimizer loop has no reason to return to the host every step;
    the chain amortizes the per-dispatch host round trip K-fold (kept
    until measured on the card).  The step body is unrolled (static
    n_steps).  Returns (losses (n_steps,), params, opt_state).
    """
    return _fit_chain_jit(scene, params, target, cfg, mesh, opt,
                          opt_state, n_steps)
