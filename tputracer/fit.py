"""Inverse rendering: fit scene parameters to a target image (M3).

The BASELINE north_star capability: "recover albedo + emitter intensity"
by gradient descent through the renderer.  This is a NEW capability of
this framework (the reference renderer is not differentiable).

Design:
  * parameters = any differentiable Scene leaves (mat_albedo,
    mat_emission, mat_ior); gradients flow through the detached-sampling
    estimator (SURVEY.md §3.6).
  * single-device or mesh-sharded (tputracer.dist.fit_step_sharded) —
    gradients all-reduce across devices inside the backward pass.
  * checkpoint/resume every K steps (SURVEY.md §5 "Checkpoint/resume"):
    restarts reproduce the uninterrupted trajectory exactly because the
    per-step RNG is keyed by the step number, not wall clock.
"""

from __future__ import annotations

import json
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax

DEFAULT_PARAMS = ("mat_albedo", "mat_emission")

# projection ranges keeping parameters physical during optimization
_PARAM_RANGES = {
    "mat_albedo": (0.0, 1.0),
    "mat_emission": (0.0, None),
    "mat_ior": (1.0, 3.0),
}


def _project(params):
    out = {}
    for k, v in params.items():
        lo, hi = _PARAM_RANGES.get(k, (None, None))
        out[k] = jnp.clip(v, lo, hi)
    return out


def _render_for(integrator):
    """Static dispatch of the fit loss's forward renderer.  "bdpt"
    differentiates through integrators.bdpt.render_bdpt — the t=1
    segment_sum splat and the MIS ratio chains are plain XLA and carry
    exact VJPs (tests/unit/test_bdpt_grad.py validates FD-vs-AD)."""
    if integrator == "bdpt":
        from tputracer.integrators.bdpt import render_bdpt

        return render_bdpt
    from tputracer.integrators.pt import render_pt

    return render_pt


def _single_step(scene, params, target, cfg, integrator):
    """(loss, grads) of the mean-squared pixel loss on one device."""
    render = _render_for(integrator)

    def loss_fn(p):
        img, _ = render(scene.replace(**p), cfg)
        return jnp.mean((img - target) ** 2)

    return jax.value_and_grad(loss_fn)(params)


def chain_steps(step_fn, scene, params, target, opt, opt_state, n_steps):
    """Shared K-step fused optimizer loop (round-5 dedup: previously
    copy-pasted across the single / DP / BDPT-DP / tiled chain jits).

    step_fn(scene, params, target) -> (loss, grads).  CONTRACT: step_fn
    must apply params to the scene ITSELF inside its loss function
    (``scene.replace(**p)`` under value_and_grad) — that is what puts
    params into the autodiff graph; every existing step does.  The
    chain passes the raw scene through unchanged.

    Unrolled (static n_steps), kept so until measured on the card
    against lax.scan.  Callers jit this with their step closed over
    (cfg, mesh, ...) statics."""
    losses = []
    for _ in range(n_steps):
        loss, grads = step_fn(scene, params, target)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = _project(optax.apply_updates(params, updates))
        losses.append(loss)
    return jnp.stack(losses), params, opt_state


@partial(jax.jit, static_argnums=(3, 4, 6))
def _fit_step_single(scene, params, target, cfg, opt, opt_state,
                     integrator="pt"):
    loss, grads = _single_step(scene, params, target, cfg, integrator)
    updates, opt_state = opt.update(grads, opt_state, params)
    params = _project(optax.apply_updates(params, updates))
    return loss, params, opt_state


@partial(jax.jit, static_argnums=(3, 4, 6, 7))
def _fit_chain_single(scene, params, target, cfg, opt, opt_state, n_steps,
                      integrator="pt"):
    """n_steps fused single-device optimization steps in ONE dispatch
    (see dist.mesh.fit_chain_sharded)."""
    return chain_steps(
        lambda sc, p, t: _single_step(sc, p, t, cfg, integrator),
        scene, params, target, opt, opt_state, n_steps)


def save_checkpoint(path, step, params, opt_state):
    """Flat .npz checkpoint: params + optimizer pytree leaves + step."""
    leaves, treedef = jax.tree_util.tree_flatten((params, opt_state))
    arrs = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)}
    np.savez(path, n_leaves=len(leaves), step=step, **arrs)


def load_checkpoint(path, params, opt_state):
    """Restore (step, params, opt_state); shapes come from the templates."""
    z = np.load(path)
    leaves = [jnp.asarray(z[f"leaf_{i}"]) for i in range(int(z["n_leaves"]))]
    _, treedef = jax.tree_util.tree_flatten((params, opt_state))
    params, opt_state = jax.tree_util.tree_unflatten(treedef, leaves)
    return int(z["step"]), params, opt_state


def fit(
    scene,
    target,
    param_names=DEFAULT_PARAMS,
    cfg=None,
    steps=100,
    learning_rate=5e-2,
    optimizer=None,
    mesh=None,
    init=None,
    checkpoint_path=None,
    checkpoint_every=25,
    resume=True,
    log_every=10,
    log_file=None,
    tensorboard_dir=None,
    steps_per_dispatch=8,
    integrator="pt",
    tiled=False,
):
    """Gradient-descend scene parameters toward a target image.

    Returns (fitted_scene, params, history) where history is a list of
    {"step": i, "loss": v} dicts.  Observability (SURVEY.md §5): history
    + optional JSONL (log_file) + optional TensorBoard scalars
    (tensorboard_dir; loss, step time, steps/s, per-parameter mean |value|).

    steps_per_dispatch chains K optimization steps into one compiled
    program (single-device and sharded alike); K = 8 is kept until
    measured on the card.  Chain boundaries snap to the checkpoint_every
    grid, which is what makes checkpoint resume reproduce an
    uninterrupted same-config run bitwise; runs with *different*
    chaining agree only to float-fusion tolerance (XLA fuses a K-step
    program differently from K 1-step programs).

    integrator: "pt" (default) or "bdpt" — which renderer the loss
    differentiates through.  "bdpt" needs a BdptConfig cfg; with mesh=
    it runs rays-DP-sharded (dist.mesh.fit_step_bdpt_sharded: the t=1
    splat coupling backpropagates through the splat psum, validated
    against single-device grads).

    tiled=True (needs mesh=, integrator="pt", a clustered scene): the
    GEOMETRY is sharded C/P per device and rays ring-rotate past every
    shard (dist.scene_shard) — inverse rendering for scenes that
    outgrow one device's memory.
    """
    from tputracer.config import BdptConfig, RenderConfig

    if tiled and (mesh is None or integrator != "pt"):
        raise ValueError("fit(tiled=True) needs mesh= and integrator='pt'")
    if integrator == "bdpt":
        cfg = cfg or BdptConfig(width=64, height=64, spp=8, max_bounces=3)
    else:
        cfg = cfg or RenderConfig(width=64, height=64, spp=8, max_bounces=3)
    target = jnp.asarray(target, jnp.float32)
    opt = optimizer or optax.adam(learning_rate)

    params = dict(init) if init else {k: getattr(scene, k) for k in param_names}
    opt_state = opt.init(params)
    start = 0

    if checkpoint_path and resume and os.path.exists(checkpoint_path):
        start, params, opt_state = load_checkpoint(
            checkpoint_path, params, opt_state)

    if mesh is not None:
        from tputracer.dist import (fit_chain_bdpt_sharded,
                                    fit_chain_sharded,
                                    fit_chain_tiled,
                                    fit_step_opt_sharded)

    history = []
    logf = open(log_file, "a") if log_file else None
    tb = None
    if tensorboard_dir:
        from tensorboardX import SummaryWriter

        tb = SummaryWriter(tensorboard_dir)
    import time as _time
    t_last = _time.perf_counter()
    step = start
    while step < steps:
        sc = scene.replace(**params)
        # chain up to steps_per_dispatch steps in ONE program
        k = max(1, min(steps_per_dispatch, steps - step))
        if checkpoint_path and checkpoint_every:
            nxt = (step // checkpoint_every + 1) * checkpoint_every
            k = min(k, nxt - step)
        if mesh is not None and tiled:
            losses, params, opt_state = fit_chain_tiled(
                scene, params, target, cfg, mesh, opt, opt_state, k)
            losses = [float(x) for x in losses]
        elif mesh is not None and integrator == "bdpt":
            losses, params, opt_state = fit_chain_bdpt_sharded(
                scene, params, target, cfg, mesh, opt, opt_state, k)
            losses = [float(x) for x in losses]
        elif mesh is not None and k > 1:
            losses, params, opt_state = fit_chain_sharded(
                sc, params, target, cfg, mesh, opt, opt_state, k)
            losses = [float(x) for x in losses]
        elif mesh is not None:
            loss, params, opt_state = fit_step_opt_sharded(
                sc, params, target, cfg, mesh, opt, opt_state)
            losses = [float(loss)]
        elif k > 1:
            losses, params, opt_state = _fit_chain_single(
                scene, params, target, cfg, opt, opt_state, k, integrator)
            losses = [float(x) for x in losses]
        else:
            loss, params, opt_state = _fit_step_single(
                scene, params, target, cfg, opt, opt_state, integrator)
            losses = [float(loss)]
        for i, lv in enumerate(losses):
            rec = {"step": step + i, "loss": lv}
            history.append(rec)
            if logf:
                logf.write(json.dumps(rec) + "\n")
            if log_every and (step + i) % log_every == 0:
                print(f"fit step {step + i}: loss {lv:.6f}")
        if tb:
            now = _time.perf_counter()
            for i, lv in enumerate(losses):
                tb.add_scalar("fit/loss", lv, step + i)
            tb.add_scalar("fit/step_seconds", (now - t_last) / len(losses),
                          step + len(losses) - 1)
            tb.add_scalar("fit/steps_per_s",
                          len(losses) / max(now - t_last, 1e-9),
                          step + len(losses) - 1)
            t_last = now
            for kk, v in params.items():
                tb.add_scalar(f"fit/{kk}_mean_abs",
                              float(jnp.mean(jnp.abs(v))),
                              step + len(losses) - 1)
        step += len(losses)
        if checkpoint_path and checkpoint_every and (
                step % checkpoint_every == 0 or step == steps):
            save_checkpoint(checkpoint_path, step, params, opt_state)
    if logf:
        logf.close()
    if tb:
        tb.close()
    return scene.replace(**params), params, history
