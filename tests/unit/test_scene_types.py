"""The Scene pytree (frozen dataclasses registered with JAX, no flax) and
the compile-cache helper."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tputracer import compile_cache
from tputracer.scene import cornell_box
from tputracer.scene.types import Camera, Scene


def test_scene_pytree_leaves_and_statics():
    """Array fields are leaves (camera's four included); n_tris, eps and
    leaf_size are static metadata, not leaves."""
    sc = cornell_box("spheres")
    leaves, treedef = jax.tree_util.tree_flatten(sc)
    n_arrays = len([f for f in dataclasses.fields(Scene)
                    if f.name not in ("camera", "n_tris", "eps",
                                      "leaf_size")])
    assert len(leaves) == n_arrays + len(dataclasses.fields(Camera))
    assert all(isinstance(x, jax.Array) for x in leaves)
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert (back.n_tris, back.eps, back.leaf_size) == \
        (sc.n_tris, sc.eps, sc.leaf_size)
    with pytest.raises(dataclasses.FrozenInstanceError):
        sc.n_tris = 3


def test_scene_replace_keeps_statics():
    sc = cornell_box("boxes")
    alb = sc.mat_albedo * 0.5
    sc2 = sc.replace(mat_albedo=alb)
    assert sc2 is not sc and isinstance(sc2, Scene)
    np.testing.assert_array_equal(np.asarray(sc2.mat_albedo),
                                  np.asarray(alb))
    assert sc2.n_tris == sc.n_tris and sc2.camera is sc.camera
    cam = sc.camera.replace(o=jnp.zeros(3))
    np.testing.assert_array_equal(np.asarray(cam.o), 0.0)


def test_scene_statics_are_jit_statics():
    """A jitted function of a Scene retraces when a static field changes
    and not when an array leaf changes."""
    traces = []

    @jax.jit
    def f(sc):
        traces.append(sc.eps)
        return jnp.sum(sc.mat_albedo) * sc.eps

    sc = cornell_box("boxes")
    f(sc)
    f(sc.replace(mat_albedo=sc.mat_albedo * 2.0))
    assert len(traces) == 1
    out = f(sc.replace(eps=2e-4))
    assert len(traces) == 2 and traces[-1] == 2e-4
    assert hash(jax.tree_util.tree_structure(sc)) == \
        hash(jax.tree_util.tree_structure(sc.replace(mat_ior=sc.mat_ior)))
    np.testing.assert_allclose(float(out),
                               float(jnp.sum(sc.mat_albedo)) * 2e-4,
                               rtol=1e-6)


def test_compile_cache_dir_env_and_default(monkeypatch):
    """JAX_COMPILATION_CACHE_DIR wins when set and enable() leaves JAX's
    own setting alone; otherwise the fixed <repo>/.jax_cache."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    assert compile_cache.DEFAULT_DIR == os.path.join(repo, ".jax_cache")
    assert compile_cache.cache_dir({}) == compile_cache.DEFAULT_DIR
    assert compile_cache.cache_dir({"JAX_COMPILATION_CACHE_DIR": ""}) == \
        compile_cache.DEFAULT_DIR
    assert compile_cache.cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}) == "/elsewhere"

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    assert compile_cache.enable() == "/elsewhere" and calls == []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert compile_cache.enable() == compile_cache.DEFAULT_DIR
    assert calls == [("jax_compilation_cache_dir",
                      compile_cache.DEFAULT_DIR)]
