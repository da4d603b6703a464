"""Counter-based, placement-invariant sampler (SURVEY.md §2 row 2).

The reference uses a stateful per-thread C RNG (SURVEY.md §1a "Sampling/RNG"
layer).  Stateful RNG is hostile to both jit (hidden state) and sharding
(placement-dependent streams), so this design replaces it with a
pure counter-based hash: every sample is a deterministic function of

    (path_uid, salt, seed)

where ``path_uid`` identifies the path (pixel*spp + sample index — global,
so the stream is identical no matter how the wavefront is sharded across
chips), ``salt`` encodes (bounce, dimension-group), and ``seed`` is the
frame seed.  This is the standard GPU-tracer construction (pcg3d/pcg4d of
Jarzynski & Olano, JCGT 2020) and is pure elementwise integer math — no
threefry tables, no state, bitwise reproducible on CPU/GPU/NumPy.

The NumPy twin (`uniform3_np`) is used by the golden-test oracle so oracle
and wavefront renderer consume *identical* random numbers (tests/oracle).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

# Dimension-group slots within one bounce.  One uniform3() call yields 3
# dims; a path consumes at most SALT_STRIDE groups per bounce.
SALT_STRIDE = 8
SLOT_LIGHT = 0      # light pick + light-surface (u,v)
SLOT_BSDF = 1       # lobe pick + direction (u,v)
SLOT_RR = 2         # russian roulette
SLOT_CAMERA = 3     # pixel jitter (bounce 0 only)
SLOT_LIGHT_ORIGIN = 4   # BDPT light-subpath origin: emitter pick + (u,v)
SLOT_LIGHT_DIR = 5      # BDPT light-subpath emission direction
SLOT_LBSDF = 6          # BDPT light-subpath BSDF sampling (per bounce)

_INV_2_24 = np.float32(1.0 / 16777216.0)


def _pcg3d(v0, v1, v2, xp):
    """pcg3d hash: 3 x uint32 -> 3 x uint32 (Jarzynski & Olano 2020)."""
    u32 = xp.uint32
    m = u32(1664525)
    a = u32(1013904223)
    x = v0 * m + a
    y = v1 * m + a
    z = v2 * m + a
    x = x + y * z
    y = y + z * x
    z = z + x * y
    x = x ^ (x >> u32(16))
    y = y ^ (y >> u32(16))
    z = z ^ (z >> u32(16))
    x = x + y * z
    y = y + z * x
    z = z + x * y
    return x, y, z


def _to_unit(bits, xp):
    # top 24 bits -> [0, 1) exactly representable in f32
    return (bits >> np.uint32(8)).astype(xp.float32) * _INV_2_24


def uniform3(uid, salt, seed):
    """Three U[0,1) streams for each path.

    uid:  (N,) uint32 path ids (global, sharding-invariant)
    salt: int — bounce * SALT_STRIDE + slot
    seed: int — frame seed
    returns (N,) f32 triple (u0, u1, u2)
    """
    uid = uid.astype(jnp.uint32)
    s = jnp.uint32(np.uint32(salt))
    sd = jnp.uint32(np.uint32(seed))
    x, y, z = _pcg3d(uid, jnp.full_like(uid, s), jnp.full_like(uid, sd), jnp)
    return _to_unit(x, jnp), _to_unit(y, jnp), _to_unit(z, jnp)


def uniform3_np(uid, salt, seed):
    """NumPy twin of :func:`uniform3` — bitwise identical streams."""
    uid = np.asarray(uid, dtype=np.uint32)
    with np.errstate(over="ignore"):
        x, y, z = _pcg3d(
            uid,
            np.full_like(uid, np.uint32(salt)),
            np.full_like(uid, np.uint32(seed)),
            np,
        )
    return _to_unit(x, np), _to_unit(y, np), _to_unit(z, np)


def salt(bounce: int, slot: int) -> int:
    return int(bounce) * SALT_STRIDE + int(slot)
