"""Scene as a pytree of SoA device arrays (SURVEY.md §2 row 11).

The reference owns geometry/materials/lights/camera behind virtual
``intersect()`` interfaces (SURVEY.md §1a "Scene" layer).  Here the whole
scene is one pytree of flat float32/int32 arrays that jit captures as
device-resident constants (uploaded once — the host->device boundary of
SURVEY.md §3.1): no virtual dispatch, no AoS objects.

Materials and emission live in SoA tables indexed by per-primitive ids, so
they are ordinary differentiable pytree leaves — this is what makes the
framework differentiable in albedo / emission / IOR with zero extra
machinery (BASELINE north_star: "recover albedo + emitter intensity").

Triangles additionally carry precomputed Pluecker edge coordinates
(`plu`, shape (3, 6, T)): the inside test of a ray against a triangle is
then three 6-term dot products with the ray feature [d, o x d], shared
by the XLA reference (accel.bruteforce) and the GPU kernels.

The dataclasses are registered with ``jax.tree_util.register_dataclass``:
array fields are pytree leaves, the ``meta_fields`` are hashable static
data (part of the jit cache key).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# material kinds (BASELINE north_star: diffuse, specular, refractive)
DIFFUSE = 0
MIRROR = 1
GLASS = 2


def _pytree_dataclass(cls=None, *, meta=()):
    """Frozen dataclass registered as a pytree; ``meta`` names the static
    fields.  Adds ``.replace(**kw)`` (``dataclasses.replace``)."""
    if cls is None:
        return partial(_pytree_dataclass, meta=meta)
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **kw: dataclasses.replace(self, **kw)
    data = [f.name for f in dataclasses.fields(cls) if f.name not in meta]
    return jax.tree_util.register_dataclass(
        cls, data_fields=data, meta_fields=list(meta))


@_pytree_dataclass
class Camera:
    """Pinhole camera (SURVEY.md §2 row 12): image-plane parameterization.

    ray(u, v) = normalize(corner + u*du + v*dv - o),  u,v in [0,1)
    """

    o: jnp.ndarray        # (3,)
    corner: jnp.ndarray   # (3,) world point of pixel (0,0) corner
    du: jnp.ndarray       # (3,) full horizontal image-plane span
    dv: jnp.ndarray       # (3,) full vertical image-plane span


@_pytree_dataclass(meta=("n_tris", "eps", "leaf_size"))
class Scene:
    # triangles (padded to `n_tri_pad`; valid count = n_tris static field)
    tri_v0: jnp.ndarray   # (T,3)
    tri_e1: jnp.ndarray   # (T,3)  v1 - v0
    tri_e2: jnp.ndarray   # (T,3)  v2 - v0
    tri_n: jnp.ndarray    # (T,3)  cross(e1, e2) — unnormalized geometric normal
    tri_mat: jnp.ndarray  # (T,) int32 (padding rows point at material 0)
    tri_mask: jnp.ndarray  # (T,) f32 1.0 valid / 0.0 padding
    plu: jnp.ndarray      # (3, 6, T) Pluecker edge matrix; see accel.bruteforce

    # spheres — first-class analytic primitives (BASELINE north_star)
    sph_c: jnp.ndarray    # (S,3)
    sph_r: jnp.ndarray    # (S,)
    sph_mat: jnp.ndarray  # (S,) int32

    # material tables — the differentiable parameters
    mat_kind: jnp.ndarray      # (M,) int32 in {DIFFUSE, MIRROR, GLASS}
    mat_albedo: jnp.ndarray    # (M,3)
    mat_emission: jnp.ndarray  # (M,3) radiance of emissive surfaces
    mat_ior: jnp.ndarray       # (M,) index of refraction for GLASS

    # emitters: emissive triangle ids + areas (uniform-area light sampling),
    # plus a COMPACT copy of their geometry/material so light sampling
    # reads a few rows instead of the big triangle tables
    emit_prim: jnp.ndarray  # (E,) int32 triangle ids
    emit_area: jnp.ndarray  # (E,) f32 triangle areas
    emit_v0: jnp.ndarray    # (E,3)
    emit_e1: jnp.ndarray    # (E,3)
    emit_e2: jnp.ndarray    # (E,3)
    emit_n: jnp.ndarray     # (E,3) unit normals (emitting side)
    emit_mat: jnp.ndarray   # (E,) int32 material ids (Le via mat_emission)

    # 2-level cluster BVH (accel.bvh; empty => brute-force intersection).
    # Triangle arrays are laid out cluster-major: cluster c owns the
    # contiguous slice [c*leaf_size, (c+1)*leaf_size).
    clus_min: jnp.ndarray  # (C,3) cluster AABB minima
    clus_max: jnp.ndarray  # (C,3) cluster AABB maxima

    camera: Camera

    # statics (hashable; shape-affecting)
    n_tris: int = 0
    eps: float = 1e-4
    leaf_size: int = 128

    @property
    def n_tri_pad(self):
        return self.tri_v0.shape[0]

    @property
    def n_spheres(self):
        return self.sph_c.shape[0]

    @property
    def n_emitters(self):
        return self.emit_prim.shape[0]

    @property
    def n_clusters(self):
        return self.clus_min.shape[0]


def make_camera(o, look_at, up, vfov_deg, aspect):
    """Build a Camera from look-at parameters (host-side, NumPy)."""
    o = np.asarray(o, np.float32)
    w = np.asarray(look_at, np.float32) - o
    w = w / np.linalg.norm(w)
    up = np.asarray(up, np.float32)
    u = np.cross(w, up)
    u = u / np.linalg.norm(u)
    v = np.cross(u, w)
    h = np.tan(np.radians(vfov_deg) * 0.5)
    du = 2.0 * h * aspect * u
    dv = 2.0 * h * v
    corner = o + w - 0.5 * du - 0.5 * dv
    return Camera(
        o=jnp.asarray(o),
        corner=jnp.asarray(corner),
        du=jnp.asarray(du),
        dv=jnp.asarray(dv),
    )


def _pluecker_matrix(v0, v1, v2):
    """Per-edge Pluecker coords, packed for the (N,6)@(6,T) contraction.

    For edge a->b: direction E = b - a, moment M = a x b.  The signed
    permuted inner product with a ray (d, m = o x d) is  d.M + m.E,
    which is linear in the ray feature [d, m] — so the whole test is a
    matmul.  Edge order is chosen so w_j is proportional to barycentric
    weight of vertex j: w0 ~ edge (v1->v2), w1 ~ (v2->v0), w2 ~ (v0->v1).
    Returns (3, 6, T).
    """
    edges = [(v1, v2), (v2, v0), (v0, v1)]
    out = []
    for a, b in edges:
        e = b - a                      # (T,3)
        m = np.cross(a, b)             # (T,3)
        out.append(np.concatenate([m, e], axis=1).T)  # (6,T)
    return np.stack(out, axis=0).astype(np.float32)   # (3,6,T)


def make_scene(
    tri_vertices,      # (T,3,3) float — [v0, v1, v2] per triangle
    tri_mat,           # (T,) int
    materials,         # list of dicts: kind, albedo, emission, ior
    spheres=(),        # list of (center(3), radius, mat_id)
    camera=None,
    eps=1e-4,
    accel="auto",      # "auto" | "cluster" | "none"
    leaf_size=128,     # triangles per cluster: each traversal trip scans
                       # all C ~ T/leaf boxes, then tests leaf triangles;
                       # 128 keeps both terms of the same order on the
                       # 102k mesh (other sizes not yet measured on the card)
    cluster_threshold=2048,  # "auto": cluster scenes above this tri count
):
    """Host-side scene finalization: SoA arrays + Pluecker precompute + padding.

    The analogue of the reference's ``Scene::load`` (SURVEY.md §3.1):
    everything becomes flat device arrays, uploaded once.  Large meshes
    additionally get the 2-level cluster BVH (accel.bvh): the triangle
    SoA is emitted in cluster-major order with per-cluster AABBs, which
    is what the traversal consumes.  Unclustered scenes are not padded
    (one degenerate masked row only when there are no triangles).
    """
    tv = np.asarray(tri_vertices, np.float32)
    assert tv.ndim == 3 and tv.shape[1:] == (3, 3), tv.shape
    T = tv.shape[0]

    use_clusters = accel == "cluster" or (
        accel == "auto" and T > cluster_threshold)
    if use_clusters:
        from tputracer.accel.bvh import build_clusters

        perm, mask, cmin, cmax = build_clusters(tv, leaf_size=leaf_size)
        Tp = perm.shape[0]
        # padding slots repeat triangle 0; zero their geometry so they are
        # degenerate (never intersected) and point them at material 0
        v0 = tv[perm, 0] * mask[:, None]
        v1 = tv[perm, 1] * mask[:, None]
        v2 = tv[perm, 2] * mask[:, None]
        mat = (np.asarray(tri_mat, np.int32)[perm]
               * (mask > 0)).astype(np.int32)
    else:
        Tp = max(T, 1)
        v0 = np.zeros((Tp, 3), np.float32)
        v1 = np.zeros((Tp, 3), np.float32)
        v2 = np.zeros((Tp, 3), np.float32)
        v0[:T], v1[:T], v2[:T] = tv[:, 0], tv[:, 1], tv[:, 2]
        # padding rows: keep degenerate (zeros); masked out via tri_mask
        mat = np.zeros((Tp,), np.int32)
        mat[:T] = np.asarray(tri_mat, np.int32)
        mask = np.zeros((Tp,), np.float32)
        mask[:T] = 1.0
        cmin = np.zeros((0, 3), np.float32)
        cmax = np.zeros((0, 3), np.float32)

    e1 = v1 - v0
    e2 = v2 - v0
    n = np.cross(e1, e2)

    m_kind = np.array([m["kind"] for m in materials], np.int32)
    m_alb = np.array([m.get("albedo", (0, 0, 0)) for m in materials], np.float32)
    m_emit = np.array([m.get("emission", (0, 0, 0)) for m in materials], np.float32)
    m_ior = np.array([m.get("ior", 1.5) for m in materials], np.float32)

    # emitters = valid triangles whose material emits
    emissive_mat = np.any(m_emit > 0.0, axis=1)
    emit_ids = np.nonzero(emissive_mat[mat] & (mask > 0))[0].astype(np.int32)
    areas = 0.5 * np.linalg.norm(n[emit_ids], axis=1).astype(np.float32)

    if spheres:
        sc = np.array([s[0] for s in spheres], np.float32).reshape(-1, 3)
        sr = np.array([s[1] for s in spheres], np.float32)
        sm = np.array([s[2] for s in spheres], np.int32)
    else:
        sc = np.zeros((0, 3), np.float32)
        sr = np.zeros((0,), np.float32)
        sm = np.zeros((0,), np.int32)

    return Scene(
        tri_v0=jnp.asarray(v0),
        tri_e1=jnp.asarray(e1),
        tri_e2=jnp.asarray(e2),
        tri_n=jnp.asarray(n.astype(np.float32)),
        tri_mat=jnp.asarray(mat),
        tri_mask=jnp.asarray(mask),
        plu=jnp.asarray(_pluecker_matrix(v0, v1, v2)),
        sph_c=jnp.asarray(sc),
        sph_r=jnp.asarray(sr),
        sph_mat=jnp.asarray(sm),
        mat_kind=jnp.asarray(m_kind),
        mat_albedo=jnp.asarray(m_alb),
        mat_emission=jnp.asarray(m_emit),
        mat_ior=jnp.asarray(m_ior),
        emit_prim=jnp.asarray(emit_ids),
        emit_area=jnp.asarray(areas),
        emit_v0=jnp.asarray(v0[emit_ids]),
        emit_e1=jnp.asarray(e1[emit_ids]),
        emit_e2=jnp.asarray(e2[emit_ids]),
        emit_n=jnp.asarray(
            n[emit_ids]
            / np.maximum(np.linalg.norm(n[emit_ids], axis=1, keepdims=True),
                         1e-20).astype(np.float32)),
        emit_mat=jnp.asarray(mat[emit_ids]),
        clus_min=jnp.asarray(cmin),
        clus_max=jnp.asarray(cmax),
        camera=camera,
        n_tris=T,
        eps=float(eps),
        leaf_size=int(leaf_size),
    )
