"""Acceleration-structure oracle tests (SURVEY.md §4 item 1): the cluster
BVH traversal must agree EXACTLY with brute-force all-primitives argmin on
the same scene arrays — same t, same prim id, same occlusion verdict.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from tputracer.accel import (
    intersect_brute,
    intersect_clustered,
    occluded_brute,
    occluded_clustered,
)
from tputracer.scene.mesh import load_obj, mesh_scene, obj_scene
from tputracer.scene.types import DIFFUSE, make_camera, make_scene


def _random_scene(n_tris=257, n_spheres=2, seed=0, leaf_size=16):
    r = np.random.default_rng(seed)
    base = r.uniform(-1, 1, (n_tris, 1, 3))
    tv = (base + r.uniform(-0.25, 0.25, (n_tris, 3, 3))).astype(np.float32)
    mats = r.integers(0, 2, n_tris).astype(np.int32)
    materials = [
        {"kind": DIFFUSE, "albedo": (0.5, 0.5, 0.5)},
        {"kind": DIFFUSE, "albedo": (0, 0, 0), "emission": (5, 5, 5)},
    ]
    spheres = [((0.2, 0.1, 0.0), 0.3, 0), ((-0.4, -0.2, 0.3), 0.2, 1)]
    cam = make_camera((0, 0, -3), (0, 0, 0), (0, 1, 0), 40.0, 1.0)
    return make_scene(tv, mats, materials, spheres=spheres[:n_spheres],
                      camera=cam, accel="cluster", leaf_size=leaf_size)


def _random_rays(n, seed=1):
    r = np.random.default_rng(seed)
    o = r.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def test_clustered_matches_brute_closest_hit():
    scene = _random_scene()
    o, d = _random_rays(512)
    tmin = jnp.zeros((512,))
    tmax = jnp.full((512,), 3.0e38)
    hb = intersect_brute(scene, o, d, tmin, tmax)
    hc = intersect_clustered(scene, o, d, tmin, tmax)
    np.testing.assert_array_equal(np.asarray(hb.valid), np.asarray(hc.valid))
    v = np.asarray(hb.valid)
    np.testing.assert_array_equal(np.asarray(hb.prim)[v], np.asarray(hc.prim)[v])
    np.testing.assert_allclose(np.asarray(hb.t)[v], np.asarray(hc.t)[v],
                               rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(hb.mat)[v], np.asarray(hc.mat)[v])


def test_clustered_matches_brute_any_hit():
    scene = _random_scene(seed=3)
    o, d = _random_rays(512, seed=4)
    tmax = jnp.full((512,), 1.5)
    ob = np.asarray(occluded_brute(scene, o, d, tmax))
    oc = np.asarray(occluded_clustered(scene, o, d, tmax))
    np.testing.assert_array_equal(ob, oc)


def test_clustered_respects_tmin_tmax_window():
    scene = _random_scene(seed=7)
    o, d = _random_rays(256, seed=8)
    tmin = jnp.full((256,), 0.8)
    tmax = jnp.full((256,), 2.0)
    hb = intersect_brute(scene, o, d, tmin, tmax)
    hc = intersect_clustered(scene, o, d, tmin, tmax)
    np.testing.assert_array_equal(np.asarray(hb.valid), np.asarray(hc.valid))
    v = np.asarray(hb.valid)
    np.testing.assert_array_equal(np.asarray(hb.prim)[v], np.asarray(hc.prim)[v])


def test_mesh_scene_renders():
    """Small-subdiv mesh scene (config 3 shape) end-to-end through PT."""
    from tputracer.api import render
    from tputracer.config import RenderConfig

    scene = mesh_scene(subdiv=3, leaf_size=32, accel="cluster")
    assert scene.n_clusters > 8
    cfg = RenderConfig(width=12, height=12, spp=2, max_bounces=2,
                       rr_start=1, chunk_size=12 * 12 * 2)
    img, _ = render(scene, cfg)
    img = np.asarray(img)
    assert np.isfinite(img).all()
    assert img.mean() > 1e-3, img.mean()


def test_pallas_kernel_matches_brute_interpret():
    """The Triton traversal kernel (accel.traverse_gpu), run in
    interpreter mode, against brute force: closest hit and any-hit."""
    from tputracer.accel.traverse_gpu import (intersect_traverse,
                                              occluded_traverse)

    scene = _random_scene(n_tris=300, leaf_size=16, seed=11)
    o, d = _random_rays(600, seed=12)
    tmin = jnp.zeros((600,))
    tmax = jnp.full((600,), 3.0e38)
    hb = intersect_brute(scene, o, d, tmin, tmax)
    hp = intersect_traverse(scene, o, d, tmin, tmax, interpret=True)
    v = np.asarray(hb.valid)
    np.testing.assert_array_equal(np.asarray(hp.valid), v)
    np.testing.assert_array_equal(np.asarray(hp.prim)[v], np.asarray(hb.prim)[v])
    # same Pluecker + plane-equation math as brute force, summed in
    # another order: atol covers the cancellation in (v0.n - o.n) of a
    # hit close to the ray origin, at this unit scene scale
    np.testing.assert_allclose(np.asarray(hp.t)[v], np.asarray(hb.t)[v],
                               rtol=1e-5, atol=1e-6)
    ob = np.asarray(occluded_brute(scene, o, d, jnp.full((600,), 1.5)))
    op = np.asarray(occluded_traverse(scene, o, d, jnp.full((600,), 1.5),
                                      interpret=True))
    np.testing.assert_array_equal(ob, op)


def test_pallas_kernel_mixed_liveness_interpret():
    """The traversal kernel's wavefront-facing paths: per-lane tmax=0
    dead lanes, varied finite tmax, all-dead blocks, and a ray count that
    is not a multiple of the block.  Dead lanes come back invalid and
    unoccluded; live lanes match brute force exactly."""
    from tputracer.accel.traverse_gpu import (BLOCK, intersect_traverse,
                                              occluded_traverse)

    n = 5 * BLOCK + 7                 # ragged tail
    scene = _random_scene(n_tris=300, leaf_size=16, seed=21)
    o, d = _random_rays(n, seed=22)
    r = np.random.default_rng(23)
    tmax_np = r.uniform(0.5, 4.0, n).astype(np.float32)
    # kill whole blocks and scattered single lanes
    tmax_np[BLOCK:3 * BLOCK] = 0.0
    tmax_np[r.integers(0, n, n // 4)] = 0.0
    tmin = jnp.zeros((n,))
    tmax = jnp.asarray(tmax_np)
    hb = intersect_brute(scene, o, d, tmin, tmax)
    hp = intersect_traverse(scene, o, d, tmin, tmax, interpret=True)
    dead = tmax_np == 0.0
    assert not np.asarray(hp.valid)[dead].any()
    np.testing.assert_array_equal(np.asarray(hp.valid), np.asarray(hb.valid))
    v = np.asarray(hb.valid)
    np.testing.assert_array_equal(np.asarray(hp.prim)[v],
                                  np.asarray(hb.prim)[v])
    np.testing.assert_allclose(np.asarray(hp.t)[v], np.asarray(hb.t)[v],
                               rtol=1e-5, atol=1e-6)
    ob = np.asarray(occluded_brute(scene, o, d, tmax))
    op = np.asarray(occluded_traverse(scene, o, d, tmax, interpret=True))
    assert not op[dead].any()
    np.testing.assert_array_equal(ob, op)


def test_traversal_kernel_spheres_and_mesh_anyhit_interpret():
    """Traversal kernel on a clustered mesh scene WITH analytic spheres
    (the sphere pre-pass seeds the walk): shadow rays of mixed length
    match brute force, and closest hits land on spheres and triangles
    alike."""
    from tputracer.accel.traverse_gpu import (intersect_traverse,
                                              occluded_traverse)

    scene = mesh_scene(subdiv=2, leaf_size=32, accel="cluster")
    scene = make_scene(
        np.stack([np.asarray(scene.tri_v0),
                  np.asarray(scene.tri_v0 + scene.tri_e1),
                  np.asarray(scene.tri_v0 + scene.tri_e2)], axis=1)[
            np.asarray(scene.tri_mask) > 0],
        np.zeros((int(np.sum(np.asarray(scene.tri_mask) > 0)),), np.int32),
        [{"kind": DIFFUSE, "albedo": (0.5, 0.5, 0.5)}],
        spheres=[((0.0, 0.3, -1.2), 0.25, 0), ((0.6, 0.0, 0.0), 0.3, 0)],
        camera=scene.camera, accel="cluster", leaf_size=32)
    n = 300
    o, d = _random_rays(n, seed=52)
    o = o * 1.5
    # a third of the rays aimed at the sphere centres
    aim = jnp.asarray([[0.0, 0.3, -1.2], [0.6, 0.0, 0.0]])[
        jnp.arange(n // 3) % 2] - o[:n // 3]
    d = d.at[:n // 3].set(aim / jnp.linalg.norm(aim, axis=1, keepdims=True))
    r = np.random.default_rng(53)
    tmax = jnp.asarray(r.uniform(0.2, 6.0, n).astype(np.float32))
    ob = np.asarray(occluded_brute(scene, o, d, tmax))
    op = np.asarray(occluded_traverse(scene, o, d, tmax, interpret=True))
    assert 0 < ob.sum() < n
    np.testing.assert_array_equal(ob, op)
    tmin = jnp.zeros((n,))
    far = jnp.full((n,), 3.0e38)
    hb = intersect_brute(scene, o, d, tmin, far)
    hp = intersect_traverse(scene, o, d, tmin, far, interpret=True)
    v = np.asarray(hb.valid)
    prim = np.asarray(hb.prim)[v]
    assert (prim >= scene.n_tri_pad).any() and (prim < scene.n_tri_pad).any()
    np.testing.assert_array_equal(np.asarray(hp.prim)[v], prim)


@pytest.mark.parametrize("variant", ["boxes", "spheres"])
def test_fused_kernel_matches_brute_interpret(variant):
    """The Triton small-scene intersector (accel.intersect_gpu) in
    interpreter mode against intersect_brute on a Cornell scene: dead
    lanes, a ray count off the block size, closest hit and any-hit."""
    from tputracer.accel.intersect_gpu import (BLOCK, intersect_fused,
                                               occluded_fused)
    from tputracer.scene import cornell_box

    scene = cornell_box(variant)
    n = 4 * BLOCK + 37
    r = np.random.default_rng(61)
    o = jnp.asarray(r.uniform(0.05, 0.95, (n, 3)).astype(np.float32))
    dn = r.normal(size=(n, 3)).astype(np.float32)
    d = jnp.asarray(dn / np.linalg.norm(dn, axis=1, keepdims=True))
    tmax_np = np.full((n,), 3.0e38, np.float32)
    tmax_np[r.random(n) < 0.3] = 0.0
    tmax_np[BLOCK:2 * BLOCK] = 0.0                 # one all-dead block
    tmin = jnp.zeros((n,))
    tmax = jnp.asarray(tmax_np)
    hb = intersect_brute(scene, o, d, tmin, tmax)
    hf = intersect_fused(scene, o, d, tmin, tmax, interpret=True)
    v = np.asarray(hb.valid)
    assert v.sum() > n // 4
    np.testing.assert_array_equal(np.asarray(hf.valid), v)
    np.testing.assert_array_equal(np.asarray(hf.prim), np.asarray(hb.prim))
    np.testing.assert_allclose(np.asarray(hf.t)[v], np.asarray(hb.t)[v],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(hf.mat), np.asarray(hb.mat))
    ts = jnp.asarray(r.uniform(0.1, 1.2, n).astype(np.float32))
    ob = np.asarray(occluded_brute(scene, o, d, ts))
    of = np.asarray(occluded_fused(scene, o, d, ts, interpret=True))
    assert 0 < ob.sum() < n
    np.testing.assert_array_equal(ob, of)


def test_platform_selects_intersector():
    """The dispatch is a pure function of the platform name and the
    scene layout: kernels on "gpu", XLA references on "cpu", and an
    error (never a silent fallback) anywhere else."""
    from tputracer import accel
    from tputracer.accel import intersect_gpu, traverse_gpu

    assert accel.select("gpu", False) == (intersect_gpu.intersect_fused,
                                          intersect_gpu.occluded_fused)
    assert accel.select("gpu", True) == (traverse_gpu.intersect_traverse,
                                         traverse_gpu.occluded_traverse)
    assert accel.select("cpu", False) == (intersect_brute, occluded_brute)
    assert accel.select("cpu", True) == (intersect_clustered,
                                         occluded_clustered)
    with pytest.raises(ValueError, match="metal"):
        accel.select("metal", False)
    assert accel.current_platform() == "cpu"


def test_kernels_lower_for_cuda():
    """Both kernels lower to Triton custom calls for the CUDA platform
    (cross-platform lowering runs here without a GPU), inside a full
    render for each scene layout."""
    import jax

    from tputracer import accel
    from tputracer.config import RenderConfig
    from tputracer.integrators.pt import render_pt
    from tputracer.scene import cornell_box

    cfg = RenderConfig(width=8, height=8, spp=2, max_bounces=2,
                       chunk_size=128)
    real = accel.current_platform
    accel.current_platform = lambda: "gpu"
    try:
        for scene in (cornell_box("spheres"),
                      mesh_scene(subdiv=2, leaf_size=32, accel="cluster")):
            low = jax.jit(lambda s: render_pt(s, cfg)[0]).trace(
                scene).lower(lowering_platforms=("cuda",))
            assert "xla.gpu.triton" in low.as_text()
    finally:
        accel.current_platform = real


def test_mesh_scene_grad():
    """Gradients flow through renders of clustered scenes (the traversal
    while_loop is stop_gradient-detached — SURVEY.md §3.6)."""
    from tputracer.api import grad_render, render
    from tputracer.config import RenderConfig

    scene = mesh_scene(subdiv=2, leaf_size=32, accel="cluster")
    cfg = RenderConfig(width=8, height=8, spp=2, max_bounces=2,
                       rr_start=1, chunk_size=8 * 8 * 2)
    target = np.asarray(render(scene, cfg)[0])
    params = {"mat_albedo": scene.mat_albedo * 0.5}
    loss, grads = grad_render(scene, params, target, cfg)
    gn = float(np.abs(np.asarray(grads["mat_albedo"])).sum())
    assert np.isfinite(float(loss)) and float(loss) > 0.0
    assert np.isfinite(gn) and gn > 0.0


def test_sort_rays_invariance():
    """M5 wavefront sorting: counter-based RNG keyed on uid makes the
    render invariant under per-bounce permutation (SURVEY.md §7 M5)."""
    from tputracer.api import render
    from tputracer.config import RenderConfig

    scene = mesh_scene(subdiv=3, leaf_size=32, accel="cluster")
    cfg = RenderConfig(width=12, height=12, spp=2, max_bounces=3,
                       rr_start=2, chunk_size=12 * 12 * 2)
    a = np.asarray(render(scene, cfg)[0])
    b = np.asarray(render(scene, cfg.with_(sort_rays=True))[0])
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_obj_loader_roundtrip():
    obj = """
v 0 0 0
v 1 0 0
v 0 1 0
v 1 1 0
f 1 2 3
f 2 4 3
f -4 -3 -2 -1
"""
    tv = load_obj(obj)
    assert tv.shape == (4, 3, 3)       # 2 tris + 1 quad fan -> 2 tris
    np.testing.assert_allclose(tv[0, 1], [1, 0, 0])
    scene = obj_scene(obj, accel="none")
    assert scene.n_tris == 4


def test_obj_mtl_materials():
    """Round-5: material-aware OBJ loading — usemtl/mtllib map onto the
    three BSDF families; emissive mtl materials become area lights."""
    from tputracer.scene.mesh import load_obj_with_materials
    from tputracer.scene.types import DIFFUSE, GLASS, MIRROR

    mtl = """
newmtl red
Kd 0.8 0.1 0.1
newmtl lamp
Kd 0 0 0
Ke 10 9 8
newmtl chrome
illum 5
Ks 0.95 0.95 0.95
newmtl glass
illum 7
Ni 1.52
d 0.1
"""
    obj = """
v 0 0 0
v 1 0 0
v 0 1 0
v 1 1 0
usemtl red
f 1 2 3
usemtl lamp
f 2 4 3
usemtl chrome
f 1 3 2
usemtl glass
f 2 3 4
"""
    tv, mats, materials = load_obj_with_materials(obj, mtl_source=mtl)
    assert tv.shape == (4, 3, 3)
    kinds = [materials[m]["kind"] for m in mats]
    assert kinds == [DIFFUSE, DIFFUSE, MIRROR, GLASS]
    assert materials[mats[1]]["emission"] == (10.0, 9.0, 8.0)
    assert abs(materials[mats[3]]["ior"] - 1.52) < 1e-6
    assert materials[mats[0]]["albedo"] == (0.8, 0.1, 0.1)

    # end-to-end: the scene builds and renders with emitters found
    from tputracer.api import render
    from tputracer.config import RenderConfig
    from tputracer.scene.mesh import obj_scene

    sc = obj_scene(obj, mtl_source=mtl)
    assert sc.n_emitters > 0
    img, _ = render(sc, RenderConfig(width=8, height=8, spp=2,
                                     max_bounces=2, chunk_size=128))
    assert np.isfinite(np.asarray(img)).all()
