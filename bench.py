"""Headline benchmark: Cornell box 512x512, 16 spp, 4 bounces (the
"pt_cornell" cell).  Needs a GPU; prints ONE JSON line:

  {"metric": "rays_per_s", "value": N, "unit": "rays/s", ...}

Rays counted = (max_bounces + 1) closest-hit + max_bounces shadow rays
per path, the flat upper bound; the rays actually traced (live lanes, from
the integrator's per-bounce counters) are reported alongside.  The record
names the device it ran on.
"""

from __future__ import annotations

import json
import time


def main():
    import jax
    import numpy as np

    from benchmarks.run import device_record
    from tputracer.api import render
    from tputracer.config import RenderConfig
    from tputracer.scene import cornell_box

    dev = device_record()

    scene = cornell_box("boxes")
    cfg = RenderConfig(width=512, height=512, spp=16, max_bounces=4)
    img, _ = render(scene, cfg)
    jax.block_until_ready(img)              # compile + warm-up

    times = []
    stats = None
    for _ in range(5):
        t0 = time.perf_counter()
        img, stats = render(scene, cfg)
        jax.block_until_ready(img)
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))

    n_paths = cfg.width * cfg.height * cfg.spp
    rays = n_paths * (cfg.max_bounces + 1 + cfg.max_bounces)
    rays_issued = float(np.asarray(stats["rays_closest"]).sum()
                        + np.asarray(stats["rays_shadow"]).sum())
    print(json.dumps({
        "metric": "rays_per_s",
        "value": rays / dt,
        "unit": "rays/s",
        "rays_issued": rays_issued,
        "issued_rays_per_s": rays_issued / dt,
        "render_s": dt,
        **dev,
    }))


if __name__ == "__main__":
    main()
