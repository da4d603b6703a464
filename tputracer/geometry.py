"""Vector math on SoA ``(N, 3)`` arrays (SURVEY.md §2 row 1).

The reference's math core is a ``Vector3`` class with scalar methods
(SURVEY.md §1a "Math core").  Here it is free functions over batched
``(N, 3)`` float32 arrays — everything vectorizes and fuses into
surrounding ops; there are no scalar structs anywhere.
"""

from __future__ import annotations

import jax.numpy as jnp


def dot(a, b):
    """Batched dot product over the last axis, keepdims=False: (N,3),(N,3)->(N,)."""
    return jnp.sum(a * b, axis=-1)


def dotk(a, b):
    """Batched dot, keepdims=True: (N,3),(N,3)->(N,1)."""
    return jnp.sum(a * b, axis=-1, keepdims=True)


def cross(a, b):
    return jnp.cross(a, b)


def normalize(v, eps=1e-20):
    return v * jnp.reciprocal(jnp.sqrt(jnp.maximum(dotk(v, v), eps)))


def length(v):
    return jnp.sqrt(jnp.maximum(dot(v, v), 0.0))


def onb(n):
    """Branchless orthonormal basis from unit normals (Duff et al., JCGT 2017).

    n: (N,3) unit vectors -> (t, b): two (N,3) arrays with (t, b, n) RH frame.
    Branchless (copysign trick) so it vectorizes with no lane divergence —
    the batched replacement for the reference's if/else ONB construction.
    """
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    s = jnp.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + nz)
    b = nx * ny * a
    t = jnp.stack([1.0 + s * nx * nx * a, s * b, -s * nx], axis=-1)
    bt = jnp.stack([b, s + ny * ny * a, -ny], axis=-1)
    return t, bt


def to_world(local, n):
    """Map local-frame (N,3) directions (z = normal) to world frame."""
    t, b = onb(n)
    return (
        local[..., 0:1] * t + local[..., 1:2] * b + local[..., 2:3] * n
    )


def reflect(d, n):
    """Mirror reflection of incident direction d (pointing INTO surface)."""
    return d - 2.0 * dotk(d, n) * n


def face_forward(n, w):
    """Flip n so it lies in the same hemisphere as w."""
    return jnp.where(dotk(n, w) < 0.0, -n, n)


def cosine_sample_hemisphere(u1, u2):
    """Cosine-weighted local-frame directions; u1,u2: (N,) -> (N,3), pdf = cosθ/π."""
    r = jnp.sqrt(u1)
    phi = (2.0 * jnp.pi) * u2
    x = r * jnp.cos(phi)
    y = r * jnp.sin(phi)
    z = jnp.sqrt(jnp.maximum(1.0 - u1, 0.0))
    return jnp.stack([x, y, z], axis=-1)


def uniform_sample_sphere(u1, u2):
    """Uniform directions on the unit sphere; pdf = 1/(4π)."""
    z = 1.0 - 2.0 * u1
    r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    phi = (2.0 * jnp.pi) * u2
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def uniform_sample_triangle(u1, u2):
    """Uniform barycentrics on a triangle via the sqrt parameterization."""
    su = jnp.sqrt(u1)
    b1 = 1.0 - su
    b2 = u2 * su
    return b1, b2
