"""Differentiable BSDFs: diffuse / mirror / dielectric (SURVEY.md §2 rows 7-9).

The reference dispatches through a virtual BSDF interface with one class
per material (SURVEY.md §1a "Materials/BSDFs").  Here dispatch becomes
**masked evaluate-all-lobes**: every lane computes diffuse, mirror and
glass results and selects by material tag — three cheap elementwise
paths that XLA fuses into one pass, with no divergent branch (this is
the "EP/material-sorted dispatch" analogue of SURVEY.md §2's parallelism
table, in its simplest masked form).

Gradient discipline (SURVEY.md §3.6, "detached sampling"): sampled
directions and discrete lobe choices are constant w.r.t. parameters; the
sampling pdf appears divided by its own ``stop_gradient`` so the forward
value is unchanged (ratio == 1) while backward keeps d(f)/d(params) —
e.g. dF/d(ior) survives in the glass lobe even though F cancels
numerically against the lobe-choice probability.

Conventions: ``wo`` points away from the surface toward the previous
vertex; ``wi`` away toward the next; ``n`` is the outward geometric
normal by winding; returned pdfs are solid-angle pdfs; delta lobes report
pdf 0 and fold the discrete probability into the weight.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from tputracer import geometry as g
from tputracer.scene.types import DIFFUSE, GLASS, MIRROR

INV_PI = float(1.0 / __import__('math').pi)  # python float — see accel/bruteforce.py note


def emitted(scene, mat, n, d_in):
    """One-sided emitted radiance toward the ray (-d_in). (N,3)."""
    le = scene.mat_emission[mat]                     # (N,3)
    front = (g.dot(d_in, n) < 0.0)[:, None]
    return jnp.where(front, le, 0.0)


def eval_bsdf(scene, mat, n, wo, wi):
    """f(wo, wi) — nonzero only for the diffuse lobe (deltas never eval)."""
    kind = scene.mat_kind[mat]
    ns = g.face_forward(n, wo)
    same_side = (g.dot(wi, ns) > 0.0) & (g.dot(wo, ns) > 0.0)
    f_diff = scene.mat_albedo[mat] * INV_PI
    sel = (kind == DIFFUSE) & same_side
    return jnp.where(sel[:, None], f_diff, 0.0)


def nee_nonspecular(scene, mat):
    """Lanes whose BSDF can evaluate nonzero toward a light (NEE gate).

    Structural, not value-based: delta lobes (mirror/glass) always eval
    to 0, so their shadow rays are pure waste and are skipped.  Diffuse
    lanes are kept even when albedo is exactly 0 — the contribution must
    stay in the autodiff graph so a black-initialized material still
    receives NEE gradient (advisor finding, round 2).
    """
    return scene.mat_kind[mat] == DIFFUSE


def pdf_bsdf(scene, mat, n, wo, wi):
    """Solid-angle sampling pdf of :func:`sample_bsdf` for MIS (diffuse only)."""
    kind = scene.mat_kind[mat]
    ns = g.face_forward(n, wo)
    cos_i = g.dot(wi, ns)
    p = jnp.maximum(cos_i, 0.0) * INV_PI
    return jnp.where((kind == DIFFUSE) & (g.dot(wo, ns) > 0.0), p, 0.0)


def _fresnel_dielectric(cos_i, eta_i, eta_t):
    """Exact unpolarized Fresnel reflectance; cos_i >= 0 on the incident side."""
    sin2_t = (eta_i / eta_t) ** 2 * jnp.maximum(1.0 - cos_i**2, 0.0)
    tir = sin2_t >= 1.0
    # clamp away from 0: sqrt'(0) = inf, and TIR lanes (where cos_t is
    # unused) would poison ior-gradients with 0 * inf = NaN
    cos_t = jnp.sqrt(jnp.clip(1.0 - sin2_t, 1e-12, 1.0))
    r_par = (eta_t * cos_i - eta_i * cos_t) / (eta_t * cos_i + eta_i * cos_t)
    r_per = (eta_i * cos_i - eta_t * cos_t) / (eta_i * cos_i + eta_t * cos_t)
    f = 0.5 * (r_par**2 + r_per**2)
    return jnp.where(tir, 1.0, f), cos_t, tir


def sample_bsdf(scene, mat, n, wo, u0, u1, u2, transport_radiance=True,
                decision_scene=None):
    """Sample wi for every lane; masked-all-lobes select by material tag.

    Returns (wi, weight, pdf, is_delta):
      weight = f * |cos| / pdf   (with detached-pdf gradient trick)
      pdf    = solid-angle pdf (0 for delta lobes)

    decision_scene: optional Scene whose parameters drive the DISCRETE
    choices (the glass reflect/refract pick and its detached pick
    probability) while `scene` drives the differentiable transport math.
    Default None = `scene` (normal rendering).  This exists for the
    finite-difference validation of IOR gradients (SURVEY.md §4.4): the
    detached estimator's AD gradient treats decisions as constant, so the
    FD pair must replay the decisions of the LINEARIZATION POINT —
    rendering ior±eps with decision_scene = scene(ior0) is the estimator
    the AD gradient actually differentiates.
    """
    dsc = scene if decision_scene is None else decision_scene
    kind = scene.mat_kind[mat]
    albedo = scene.mat_albedo[mat]                   # (N,3)
    ns = g.face_forward(n, wo)                       # shading-side normal

    # --- diffuse: cosine-hemisphere ---
    wi_d = g.to_world(g.cosine_sample_hemisphere(u1, u2), ns)
    pdf_d = jnp.maximum(g.dot(wi_d, ns), 0.0) * INV_PI
    w_d = albedo                                     # f cos / pdf == albedo

    # --- mirror: perfect reflection about ns ---
    wi_m = 2.0 * g.dotk(wo, ns) * ns - wo
    w_m = albedo

    # --- glass: Fresnel-weighted reflect-or-refract ---
    entering = g.dot(wo, n) > 0.0
    ior = scene.mat_ior[mat]
    eta_i = jnp.where(entering, 1.0, ior)
    eta_t = jnp.where(entering, ior, 1.0)
    cos_i = jnp.abs(g.dot(wo, ns))
    fr, cos_t, tir = _fresnel_dielectric(cos_i, eta_i, eta_t)
    if decision_scene is None:
        fr_dec, cos_t_dec, tir_dec = fr, cos_t, tir
        eta_dec = eta_i / eta_t
    else:
        # the AD estimator detaches BOTH the lobe pick and the sampled
        # direction; the FD twin must therefore take pick, pick
        # probability, and refraction geometry from the frozen scene
        ior_d = dsc.mat_ior[mat]
        ei_d = jnp.where(entering, 1.0, ior_d)
        et_d = jnp.where(entering, ior_d, 1.0)
        fr_dec, cos_t_dec, tir_dec = _fresnel_dielectric(cos_i, ei_d, et_d)
        eta_dec = ei_d / et_d
    pick_reflect = (u0 < lax.stop_gradient(fr_dec)) | tir_dec
    eta = eta_i / eta_t
    wi_refl = 2.0 * g.dotk(wo, ns) * ns - wo
    wi_refr = g.normalize(
        -eta_dec[:, None] * wo + (eta_dec * cos_i - cos_t_dec)[:, None] * ns)
    wi_g = jnp.where(pick_reflect[:, None], wi_refl, wi_refr)
    # detached-pdf ratio: forward == 1, backward keeps dF/d(ior).  The
    # detached pick probability is the probability the pick was ACTUALLY
    # made with (fr_dec, frozen-scene Fresnel), not the transport fr.
    pr = lax.stop_gradient(jnp.clip(fr_dec, 1e-4, 1.0))
    pt = lax.stop_gradient(jnp.clip(1.0 - fr_dec, 1e-4, 1.0))
    scale_refr = jnp.where(transport_radiance, eta**2, 1.0)  # radiance transport
    w_g_refl = (fr / pr)[:, None] * albedo
    w_g_refr = ((1.0 - fr) / pt * scale_refr)[:, None] * albedo
    w_g = jnp.where(pick_reflect[:, None], w_g_refl, w_g_refr)

    # --- select by material tag ---
    is_m = (kind == MIRROR)[:, None]
    is_g = (kind == GLASS)[:, None]
    wi = jnp.where(is_g, wi_g, jnp.where(is_m, wi_m, wi_d))
    wi = lax.stop_gradient(wi)          # detached sampling: directions are data
    weight = jnp.where(is_g, w_g, jnp.where(is_m, w_m, w_d))
    pdf = jnp.where(kind == DIFFUSE, pdf_d, 0.0)
    is_delta = kind != DIFFUSE
    return wi, weight, pdf, is_delta
