"""Host-side acceleration-structure builder (SURVEY.md §2 row 5, §3.4).

The reference builds a recursive KD-tree over triangles on the CPU and
walks it per ray with a recursive near/far descent (SURVEY.md §3.4-3.5).
Here the *build* stays on the host (it runs once per scene — NumPy or the
native SAH builder) and its output is a **2-level cluster BVH**: a binary
BVH over triangle centroids flattened at a fixed leaf granularity into C
spatially-coherent clusters of at most ``leaf_size`` triangles
(zero-padded, masked).  Device arrays are emitted in cluster-major order,
so every cluster is one contiguous, statically-shaped slice of the
triangle SoA.

Both traversals walk it per ray, front to back over the C cluster boxes:
accel/clustered.py (XLA, dense (rays, clusters) arrays) and
accel/traverse_gpu.py (GPU kernel, one ray per thread).
"""

from __future__ import annotations

import os

import numpy as np


def pack_clusters(perm, mask, cmin, cmax, src_leaf, dst_leaf):
    """Greedy post-pass: pack ADJACENT (DFS-order => spatially related)
    src_leaf-sized clusters into full dst_leaf-sized ones.

    The builders run with a SMALL build leaf (dst_leaf // 4) and this
    pass bins the resulting tight little leaves into ~95%%-full dst_leaf
    clusters: same traversal granularity, ~25%% fewer clusters and
    ~tighter effective AABBs than building at dst_leaf directly (SAH
    leaves at dst_leaf average only ~70%% occupancy).  Merged AABB =
    union of member AABBs — still conservative.  Empty clusters are
    dropped.
    """
    Ls, Ld = src_leaf, dst_leaf
    C = cmin.shape[0]
    counts = mask.reshape(C, Ls).sum(axis=1).astype(np.int64)
    groups = []
    cur, cur_n = [], 0
    for c in range(C):
        k = int(counts[c])
        if k == 0:
            continue
        if cur and cur_n + k > Ld:
            groups.append(cur)
            cur, cur_n = [], 0
        cur.append(c)
        cur_n += k
    if cur:
        groups.append(cur)

    Cn = len(groups)
    nperm = np.zeros((Cn * Ld,), np.int32)
    nmask = np.zeros((Cn * Ld,), np.float32)
    ncmin = np.full((Cn, 3), 3.0e38, np.float32)
    ncmax = np.full((Cn, 3), 3.0e38, np.float32)
    for gi, grp in enumerate(groups):
        ofs = gi * Ld
        ncmin[gi] = np.min(cmin[grp], axis=0)
        ncmax[gi] = np.max(cmax[grp], axis=0)
        for c in grp:
            k = int(counts[c])
            nperm[ofs:ofs + k] = perm[c * Ls:c * Ls + k]
            nmask[ofs:ofs + k] = 1.0
            ofs += k
    return nperm, nmask, ncmin, ncmax


def build_clusters(tv, leaf_size=64, eps=1e-5):
    """Median-split BVH flattened to fixed-size leaf clusters.

    tv: (T, 3, 3) float32 triangle vertices.
    Returns (perm, pad_mask, clus_min, clus_max):
      perm     (C*leaf_size,) int32 — source triangle index per padded
               slot (padding slots repeat index 0 and are masked out)
      pad_mask (C*leaf_size,) float32 — 1.0 real / 0.0 padding
      clus_min/clus_max (C, 3) float32 — cluster AABBs (eps-padded)
    """
    # Build at the TARGET leaf; pack_clusters then only merges the rare
    # adjacent under-full pairs.  Building at leaf/4 and bin-packing
    # fills slots better (occupancy 69% -> 91% on the 82k-tri mesh) but
    # the merged boxes are fat and overlapping, so rays enter more of
    # them: tight boxes beat full slots.
    build_leaf = leaf_size

    # native binned-SAH builder when available (accel/native.py): better
    # split planes -> fewer cluster visits per ray tile at trace time
    if not os.environ.get("TPUTRACER_NO_NATIVE"):
        from tputracer.accel.native import build_clusters_native

        out = build_clusters_native(tv, leaf_size=build_leaf, eps=eps)
        if out is not None:
            return pack_clusters(*out, build_leaf, leaf_size)

    tv = np.asarray(tv, np.float32)
    T = tv.shape[0]
    cent = tv.mean(axis=1)                      # (T,3) centroids

    clusters = []
    stack = [np.arange(T, dtype=np.int64)]
    while stack:
        idx = stack.pop()
        if len(idx) <= build_leaf:
            clusters.append(idx)
            continue
        c = cent[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = np.argsort(c[:, axis], kind="stable")
        half = len(idx) // 2
        stack.append(idx[order[:half]])
        stack.append(idx[order[half:]])

    C = len(clusters)
    L = build_leaf
    perm = np.zeros((C * L,), np.int64)
    mask = np.zeros((C * L,), np.float32)
    cmin = np.full((C, 3), 3.0e38, np.float32)
    cmax = np.full((C, 3), 3.0e38, np.float32)
    for ci, idx in enumerate(clusters):
        k = len(idx)
        perm[ci * L:ci * L + k] = idx
        mask[ci * L:ci * L + k] = 1.0
        pts = tv[idx].reshape(-1, 3)
        ext = eps * max(1.0, float(np.abs(pts).max()))
        cmin[ci] = pts.min(axis=0) - ext
        cmax[ci] = pts.max(axis=0) + ext
    return pack_clusters(perm.astype(np.int32), mask, cmin, cmax,
                         build_leaf, leaf_size)
