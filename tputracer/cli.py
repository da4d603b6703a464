"""CLI entry point (SURVEY.md §2 row 15: main/CLI).

The reference's ``main()`` parses argv, picks an integrator, renders and
writes an image with timing (SURVEY.md §3.1).  Same surface here:

    python -m tputracer.cli --scene boxes --integrator pt \
        --size 256 --spp 16 --bounces 4 --out out.png
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tputracer")
    ap.add_argument("--scene", default="boxes",
                    choices=["empty", "boxes", "spheres", "glass_sphere",
                             "caustic", "furnace", "mesh", "mesh_small"])
    ap.add_argument("--obj", default=None,
                    help="render an OBJ file instead of a named scene")
    ap.add_argument("--integrator", default="pt", choices=["pt", "bdpt"])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--bounces", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mis", action="store_true")
    ap.add_argument("--exposure", type=float, default=1.0)
    ap.add_argument("--out", default="out.png")
    ap.add_argument("--profile", default=None,
                    help="dump a jax profiler trace to this directory")
    ap.add_argument("--tiled", action="store_true",
                    help="shard the GEOMETRY over all visible devices "
                         "(dist.scene_shard ring traversal) instead of "
                         "replicating it — for scenes that outgrow one "
                         "device's memory; pt only, clustered scenes only")
    args = ap.parse_args(argv)

    import jax

    from tputracer import compile_cache
    from tputracer.config import BdptConfig, RenderConfig
    from tputracer.film import save_image
    from tputracer.scene import cornell_box, furnace, mesh_scene, obj_scene

    # --tiled shards cluster-major geometry, so force the cluster BVH
    # even for scenes below the auto threshold (a Cornell box would
    # otherwise hit pad_scene_clusters' "needs a clustered scene")
    accel_kw = {"accel": "cluster"} if args.tiled else {}
    if args.obj:
        scene = obj_scene(args.obj, **accel_kw)
    elif args.scene == "furnace":
        if args.tiled:
            raise SystemExit("--tiled: the furnace scene is not clustered")
        scene = furnace()
    elif args.scene == "mesh":
        scene = mesh_scene(subdiv=6, **accel_kw)  # 102k tris (config 3)
    elif args.scene == "mesh_small":
        scene = mesh_scene(subdiv=4, **accel_kw)
    else:
        scene = cornell_box(args.scene, **accel_kw)

    if args.integrator == "pt":
        cfg = RenderConfig(width=args.size, height=args.size, spp=args.spp,
                           max_bounces=args.bounces, seed=args.seed,
                           mis=args.mis)
        if args.tiled:
            from tputracer.dist import make_mesh, render_tiled

            mesh = make_mesh((len(jax.devices()),), ("dp",))

            def run(scene, cfg):
                return render_tiled(scene, cfg, mesh)
        else:
            from tputracer.api import render as run
    else:
        if args.tiled:
            raise SystemExit("--tiled is pt-only (BDPT shards rays, not "
                             "geometry — use the DP render_bdpt_sharded)")
        from tputracer.api import render_bdpt as run
        cfg = BdptConfig(width=args.size, height=args.size, spp=args.spp,
                         max_bounces=args.bounces, seed=args.seed)

    compile_cache.enable()
    t0 = time.time()
    img, stats = run(scene, cfg)
    jax.block_until_ready(img)
    t_compile = time.time() - t0

    ctx = None
    if args.profile:
        ctx = jax.profiler.trace(args.profile)
        ctx.__enter__()
    t0 = time.time()
    img, stats = run(scene, cfg)
    jax.block_until_ready(img)
    dt = time.time() - t0
    img = np.asarray(img)
    if ctx is not None:
        ctx.__exit__(None, None, None)

    save_image(img, args.out, exposure=args.exposure)
    n_paths = args.size * args.size * args.spp
    # upper bound: (bounces + 1) closest-hit + bounces shadow rays a path
    rays = n_paths * (args.bounces + 1 + args.bounces)
    dev = jax.devices()[0]
    mem = dev.memory_stats() or {}
    print(json.dumps({
        "scene": args.scene, "integrator": args.integrator,
        "size": args.size, "spp": args.spp, "bounces": args.bounces,
        "platform": dev.platform, "device_kind": dev.device_kind,
        "compile_s": t_compile - dt, "render_s": dt,
        "rays_per_s": rays / dt, "out": args.out,
        "mean": float(img.mean()),
        "nan_pixels": int(np.isnan(img).any(axis=-1).sum()),
        "peak_bytes_in_use": mem.get("peak_bytes_in_use"),
    }))


if __name__ == "__main__":
    main()
