"""Intersection backends + trace-time dispatch (SURVEY.md §2 rows 3-6).

Two scene layouts, two implementations of each:

  ===========  =================================  =============================
  layout       GPU kernel (Pallas, Triton)        XLA reference (CPU)
  ===========  =================================  =============================
  brute force  intersect_gpu.intersect_fused      bruteforce.intersect_brute
  cluster BVH  traverse_gpu.intersect_traverse    clustered.intersect_clustered
  ===========  =================================  =============================

The choice is made once per trace from the platform the computation is
placed on (``select``, a pure function of the platform name): the GPU
kernels on ``"gpu"``, the references on ``"cpu"``.  Any other platform is
an error; nothing falls back quietly.
"""

import jax

from tputracer.accel.bruteforce import (  # noqa: F401
    Hit,
    finalize_hit,
    intersect_brute,
    occluded_brute,
)
from tputracer.accel.clustered import (  # noqa: F401
    intersect_clustered,
    occluded_clustered,
)


def select(platform, clustered):
    """(intersect_fn, occluded_fn) for a platform name and scene layout."""
    if platform == "gpu":
        if clustered:
            from tputracer.accel import traverse_gpu as k

            return k.intersect_traverse, k.occluded_traverse
        from tputracer.accel import intersect_gpu as k

        return k.intersect_fused, k.occluded_fused
    if platform == "cpu":
        if clustered:
            return intersect_clustered, occluded_clustered
        return intersect_brute, occluded_brute
    raise ValueError(f"no intersection backend for platform {platform!r}")


def current_platform():
    """Platform the computation being traced is placed on: the
    ``jax.default_device`` in effect if one is set, else the default
    backend."""
    dev = jax.config.jax_default_device
    if dev is None:
        return jax.default_backend()
    return dev if isinstance(dev, str) else dev.platform


def intersect(scene, o, d, tmin, tmax) -> Hit:
    """Closest hit over the scene."""
    fn, _ = select(current_platform(), scene.n_clusters > 0)
    return fn(scene, o, d, tmin, tmax)


def occluded(scene, o, d, tmax):
    """Any-hit shadow predicate."""
    _, fn = select(current_platform(), scene.n_clusters > 0)
    return fn(scene, o, d, tmax)
