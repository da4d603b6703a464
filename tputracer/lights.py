"""Emissive-area-light sampling for NEE and BDPT (SURVEY.md §2 row 10).

The reference samples a point on an emissive surface for direct lighting
(``AreaLight::sampleDirect``, SURVEY.md §3.2).  Batched form: the
emitter set is an SoA table of triangle ids + areas; each lane picks an
emitter uniformly and a uniform point on it via the sqrt parameterization
— all gathers over tiny tables, fully vectorized.  ``Le`` is read from
the (differentiable) material emission table, so emitter-intensity
gradients flow (BASELINE config 5).
"""

from __future__ import annotations

import jax.numpy as jnp

from tputracer import geometry as g


def sample_light(scene, u0, u1, u2):
    """Sample one emitter point per lane.

    u0,u1,u2: (N,) uniforms.
    Returns (y, n_l, le, pdf_area, prim, mat):
      y        (N,3) point on the light
      n_l      (N,3) unit normal of the light (winding side = emitting side)
      le       (N,3) emitted radiance (differentiable via mat_emission)
      pdf_area (N,)  area-measure pdf of y (uniform emitter pick x uniform area)
      prim     (N,)  int32 triangle id of the sampled emitter
      mat      (N,)  int32 material id of the emitter

    All lookups run against the COMPACT (E,)-row emitter tables — no
    gathers from the big triangle SoA.
    """
    E = scene.n_emitters
    idx = jnp.minimum((u0 * E).astype(jnp.int32), E - 1)   # (N,)
    prim = scene.emit_prim[idx]                 # (N,) triangle id
    mat = scene.emit_mat[idx]
    area = scene.emit_area[idx]
    b1, b2 = g.uniform_sample_triangle(u1, u2)
    y = (scene.emit_v0[idx]
         + b1[:, None] * scene.emit_e1[idx]
         + b2[:, None] * scene.emit_e2[idx])
    n_l = scene.emit_n[idx]
    le = scene.mat_emission[mat]
    pdf_area = 1.0 / (area * E)
    return y, n_l, le, pdf_area, prim, mat


def pdf_light_area(scene, prim):
    """Area pdf of sampling a given emissive triangle id (for MIS)."""
    E = scene.n_emitters
    # map prim -> its area via the emitter table (small E: masked reduce)
    match = scene.emit_prim[None, :] == prim[:, None]       # (N,E)
    area = jnp.sum(jnp.where(match, scene.emit_area[None, :], 0.0), axis=1)
    is_emitter = jnp.any(match, axis=1)
    pdf = jnp.where(is_emitter, 1.0 / (jnp.maximum(area, 1e-20) * E), 0.0)
    return pdf, is_emitter
