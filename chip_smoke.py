"""GPU smoke run: the renderer's main path on one card, kernels checked.

    python3 chip_smoke.py            # one GPU, phases 0-3
    python3 chip_smoke.py --multi    # four GPUs, the multi-device paths

Phases, one JSON line each:

  0  device: a GPU is required (exit 1 otherwise); JAX's device kind and
     count, and the card's name and power limit from nvidia-smi;
  1  each hand-written kernel against its XLA reference, on the card, at
     the widths the renders use (tolerances in ``check_hits``);
  2  each kernel against the plain XLA path, timed on the card: one call
     at the phase-1 shapes, and the render time of its benchmark cell;
  3  renders through the entry points (the CLI in-process, ``fit``), each
     checked for NaNs and against the same render through the plain XLA
     path on the card, and one small render compared per pixel with the
     CPU backend.

The last line is ``{"ok": true, "device": {...}}``; any failure raises
and exits non-zero before it.  Everything runs in this one process.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time

import numpy as np

from benchmarks.run import nvidia_smi

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "chiprun_out")

# --- tolerances, each with its reason -----------------------------------
# float32 on both sides, summed in different orders: a ray whose answer
# flips is either a tie (two primitives at the same t) or grazes an edge
# of the disputed triangle within rounding of the sign test
PRIM_AGREE = 0.9999     # share of rays with the same primitive
T_RTOL = 1e-5           # |t_k - t_r| / t_r where the primitives agree,
                        # scaled by the plane equation's condition
                        # (``_plane_cond``) for hits near the origin
EDGE_RTOL = 1e-5        # normalised |w| below which a ray grazes an edge
ANY_AGREE = 0.9999      # share of shadow rays with the same verdict
MEAN_RTOL = 1e-3        # render mean, kernel vs plain XLA on the card
PIXEL_ATOL = 1e-4       # 64^2 render, card vs CPU, per pixel (relative
                        # above 1), for all but PIXEL_SPARE of the pixels
PIXEL_SPARE = 1e-3      # ... which stay within PIXEL_MAX: see card_vs_cpu
PIXEL_MAX = 1e-3


def emit(obj):
    print(json.dumps(obj), flush=True)


def timed(fn, reps=5):
    """Median seconds of fn() over reps runs after one warm-up; every
    run ends in block_until_ready."""
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


@contextlib.contextmanager
def plain_xla():
    """Route intersection through the XLA references on the card: the
    dispatch is told the platform is "cpu".  Compiled programs are
    dropped on entry and exit so no trace crosses the boundary."""
    import jax

    from tputracer import accel

    real = accel.current_platform
    jax.clear_caches()
    accel.current_platform = lambda: "cpu"
    try:
        yield
    finally:
        accel.current_platform = real
        jax.clear_caches()


# --- phase 1: rays and hit comparison ------------------------------------

def ray_mix(scene, n, seed):
    """n rays: half camera rays through random image points, half
    cosine-distributed bounce rays off the camera rays' first hits; 30% of
    lanes dead (tmax = tmin = 0).  Returns (o, d, tmin, tmax_closest,
    tmax_shadow): shadow rays stop at 0.5-1.5x the camera hit distance."""
    import jax
    import jax.numpy as jnp

    from tputracer import geometry as g
    from tputracer.accel import intersect_brute, intersect_clustered

    ref = intersect_clustered if scene.n_clusters else intersect_brute
    key = jax.random.PRNGKey(seed)
    k = jax.random.split(key, 6)
    nc = n - n // 2
    cam = scene.camera
    uv = jax.random.uniform(k[0], (nc, 2))
    dc = g.normalize(cam.corner[None] + uv[:, :1] * cam.du[None]
                     + uv[:, 1:] * cam.dv[None] - cam.o[None])
    oc = jnp.broadcast_to(cam.o[None], dc.shape)
    hit = ref(scene, oc, dc, jnp.zeros((nc,)), jnp.full((nc,), 3.0e38))
    ns = g.face_forward(hit.n, -dc)
    u = jax.random.uniform(k[1], (nc, 2))
    db = g.to_world(g.cosine_sample_hemisphere(u[:, 0], u[:, 1]), ns)
    ob = hit.p + ns * 1e-4
    ob = jnp.where(hit.valid[:, None], ob, oc)
    db = jnp.where(hit.valid[:, None], db, dc)
    nb = n // 2
    o = jnp.concatenate([oc, ob[:nb]])
    d = jnp.concatenate([dc, db[:nb]])
    tmin = jnp.zeros((n,))
    dead = jax.random.uniform(k[2], (n,)) < 0.3
    t_cam = jnp.where(hit.valid, hit.t, 10.0)
    scale = jax.random.uniform(k[3], (n,), minval=0.5, maxval=1.5)
    tshadow = jnp.concatenate([t_cam, t_cam[:nb]]) * scale
    return (o, d, tmin, jnp.where(dead, 0.0, 3.0e38),
            jnp.where(dead, 0.0, tshadow))


def _edge_graze(scene, o, d, prim):
    """Per ray: does it pass within EDGE_RTOL (normalised) of an edge of
    triangle ``prim``?  float64 on the host; spheres and misses: False."""
    plu = np.asarray(scene.plu, np.float64)                    # (3,6,T)
    o, d = np.asarray(o, np.float64), np.asarray(d, np.float64)
    feat = np.concatenate([d, np.cross(o, d)], axis=1)         # (n,6)
    out = np.zeros(len(prim), bool)
    for i, p in enumerate(prim):
        if 0 <= p < plu.shape[2]:
            c = plu[:, :, p]                                   # (3,6)
            w = c @ feat[i]
            scale = np.linalg.norm(c, axis=1) * np.linalg.norm(feat[i])
            out[i] = np.min(np.abs(w) / np.maximum(scale, 1e-30)) \
                <= EDGE_RTOL
    return out


def _plane_cond(scene, o, d, prim):
    """Condition of t = (v0.n - o.n) / (d.n) in float32 per ray:
    max(1, max(|v0.n|, |o.n|) / |v0.n - o.n|).  Both sides round the
    numerator to a few ulp of its larger term, so a hit close to the ray
    origin (a bounce off a nearby wall) carries that much relative error
    in t on both; spheres count 1."""
    tri = prim < scene.n_tri_pad
    idx = np.where(tri, prim, 0)
    n = np.asarray(scene.tri_n, np.float64)[idx]
    v0n = np.sum(np.asarray(scene.tri_v0, np.float64)[idx] * n, axis=1)
    on = np.sum(np.asarray(o, np.float64) * n, axis=1)
    k = np.maximum(np.abs(v0n), np.abs(on)) / np.maximum(
        np.abs(v0n - on), 1e-30)
    return np.where(tri, np.maximum(k, 1.0), 1.0)


def check_hits(name, scene, o, d, hk, hr):
    """Kernel hit hk against reference hit hr (closest-hit)."""
    pk, pr = np.asarray(hk.prim), np.asarray(hr.prim)
    tk, tr = np.asarray(hk.t), np.asarray(hr.t)
    vk, vr = np.asarray(hk.valid), np.asarray(hr.valid)
    same = pk == pr
    agree = float(same.mean())
    bad = np.nonzero(~same)[0]
    both = vk[bad] & vr[bad]
    tie_t = both & (np.abs(tk[bad] - tr[bad])
                    <= T_RTOL * np.abs(np.where(both, tr[bad], 1.0)))
    graze = (_edge_graze(scene, np.asarray(o)[bad], np.asarray(d)[bad],
                         pk[bad])
             | _edge_graze(scene, np.asarray(o)[bad], np.asarray(d)[bad],
                           pr[bad]))
    untied = int(np.sum(~(tie_t | graze)))
    v = same & vr
    cond = _plane_cond(scene, np.asarray(o)[v], np.asarray(d)[v], pr[v])
    t_err = float(np.max(np.abs(tk[v] - tr[v]) / (np.abs(tr[v]) * cond))) \
        if v.any() else 0.0
    ok = agree >= PRIM_AGREE and untied == 0 and t_err <= T_RTOL
    rec = {"check": name, "rays": int(len(pk)), "hit_share": float(vr.mean()),
           "prim_agree": agree, "mismatches": int(len(bad)),
           "untied_mismatches": untied, "t_max_rel_err": t_err, "ok": ok}
    if not ok:
        raise AssertionError(f"kernel disagrees with reference: {rec}")
    return rec


def check_occluded(name, ok_k, ok_r):
    a, b = np.asarray(ok_k), np.asarray(ok_r)
    agree = float((a == b).mean())
    rec = {"check": name, "rays": int(len(a)), "occluded_share":
           float(b.mean()), "agree": agree, "ok": agree >= ANY_AGREE}
    if not rec["ok"]:
        raise AssertionError(f"any-hit disagrees with reference: {rec}")
    return rec


def kernel_cases():
    """(name, scene, n rays, kernel (isect, occl), reference (isect, occl))
    at the widths the renders use; each function jitted once."""
    import jax

    from tputracer import accel
    from tputracer.config import RenderConfig
    from tputracer.scene import cornell_box, mesh_scene

    def jitted(platform, clustered):
        return tuple(jax.jit(f) for f in accel.select(platform, clustered))

    chunk = RenderConfig().chunk_size             # 2^20 paths per chunk
    gpu_flat, ref_flat = jitted("gpu", False), jitted("cpu", False)
    return [
        ("fused_boxes", cornell_box("boxes"), chunk, gpu_flat, ref_flat),
        ("fused_spheres", cornell_box("spheres"), chunk, gpu_flat, ref_flat),
        ("fused_boxes_ragged", cornell_box("boxes"), chunk - 77, gpu_flat,
         ref_flat),
        ("traverse_mesh", mesh_scene(subdiv=6), 1 << 16,
         jitted("gpu", True), jitted("cpu", True)),
    ]


def phase1(cases):
    import jax

    out, arrays = [], {}
    for name, scene, n, fk, fr in cases:
        o, d, tmin, tmax, tsh = jax.jit(ray_mix, static_argnums=(1, 2))(
            scene, n, 7)
        out.append(check_hits(name, scene, o, d,
                              fk[0](scene, o, d, tmin, tmax),
                              fr[0](scene, o, d, tmin, tmax)))
        out.append(check_occluded(name + "_anyhit", fk[1](scene, o, d, tsh),
                                  fr[1](scene, o, d, tsh)))
        arrays[name] = (o, d, tmin, tmax, tsh)
    return out, arrays


def phase2_calls(cases, arrays):
    out = []
    for name, scene, _, fk, fr in cases:
        if name.endswith("_ragged"):
            continue
        o, d, tmin, tmax, tsh = arrays[name]
        rec = {"kernel": name, "rays": int(o.shape[0])}
        for i, tag, args in ((0, "closest", (tmin, tmax)),
                             (1, "anyhit", (tsh,))):
            rec[f"{tag}_kernel_s"] = timed(lambda: fk[i](scene, o, d, *args))
            rec[f"{tag}_plain_s"] = timed(lambda: fr[i](scene, o, d, *args))
        out.append(rec)
    return out


# --- cells: the repo's benchmark configurations --------------------------

def cell(name):
    """(scene, cfg, render fn) of a benchmark cell (benchmarks/run.py)."""
    from tputracer.api import render, render_bdpt
    from tputracer.config import BdptConfig, RenderConfig
    from tputracer.scene import cornell_box, mesh_scene

    if name == "pt_cornell":
        return (cornell_box("boxes"),
                RenderConfig(width=512, height=512, spp=16, max_bounces=4),
                render)
    if name == "mesh":
        return (mesh_scene(subdiv=6),
                RenderConfig(width=256, height=256, spp=4, max_bounces=8,
                             rr_start=3), render)
    if name == "bdpt_caustic":
        return (cornell_box("caustic"),
                BdptConfig(width=128, height=128, spp=8, max_bounces=4,
                           chunk_size=1 << 15), render_bdpt)
    raise KeyError(name)


def render_time(name):
    scene, cfg, fn = cell(name)
    dt = timed(lambda: fn(scene, cfg)[0])
    return dt, float(np.asarray(fn(scene, cfg)[0]).mean())


def phase2_renders():
    out = {}
    for name in ("pt_cornell", "mesh"):
        out[name] = {"kernel": render_time(name)}
    with plain_xla():
        for name in ("pt_cornell", "mesh"):
            out[name]["plain"] = render_time(name)
    return [{"cell": k, "render_s_kernel": v["kernel"][0],
             "render_s_plain": v["plain"][0],
             "mean_kernel": v["kernel"][1], "mean_plain": v["plain"][1]}
            for k, v in out.items()]


# --- phase 3: entry points ----------------------------------------------

CLI_RUNS = {
    "pt_cornell": ["--scene", "boxes", "--size", "512", "--spp", "16",
                   "--bounces", "4"],
    "mesh": ["--scene", "mesh", "--size", "256", "--spp", "4",
             "--bounces", "8"],
    "bdpt_caustic": ["--integrator", "bdpt", "--scene", "caustic",
                     "--size", "128", "--spp", "8"],
}


def run_cli(name):
    from tputracer.cli import main

    os.makedirs(OUT, exist_ok=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(CLI_RUNS[name] + ["--out", os.path.join(OUT, f"smoke_{name}.png")])
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    if rec["nan_pixels"]:
        raise AssertionError(f"NaN pixels in {name}: {rec}")
    return rec


def run_fit():
    import jax
    import optax

    from tputracer.api import render
    from tputracer.config import RenderConfig
    from tputracer.fit import fit
    from tputracer.scene import cornell_box

    scene = cornell_box("boxes")
    cfg = RenderConfig(width=128, height=128, spp=4, max_bounces=3,
                       rr_start=2, chunk_size=1 << 16)
    target = render(scene, cfg)[0]
    init = {"mat_albedo": scene.mat_albedo * 0.5,
            "mat_emission": scene.mat_emission * 2.0}
    # one optimizer object: it is a static argument of the compiled chain,
    # so the second fit reuses the first one's program
    kw = dict(cfg=cfg, init=init, optimizer=optax.adam(5e-2),
              steps_per_dispatch=4, log_every=0)
    t0 = time.perf_counter()
    fit(scene, target, steps=4, **kw)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    fitted, _, hist = fit(scene, target, steps=8, **kw)
    dt = (time.perf_counter() - t0) / 8
    losses = [h["loss"] for h in hist]
    img = np.asarray(render(fitted, cfg)[0])
    rec = {"run": "fit", "compile_s": t_first - 4 * dt, "render_s": dt,
           "losses": losses, "mean": float(img.mean()),
           "nan_pixels": int(np.isnan(img).any(axis=-1).sum()),
           "peak_bytes_in_use": (jax.devices()[0].memory_stats()
                                 or {}).get("peak_bytes_in_use")}
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]
            and rec["nan_pixels"] == 0):
        raise AssertionError(f"fit did not converge: {rec}")
    return rec


def card_vs_cpu():
    """Cornell 'spheres' 64^2, 4 spp, rendered on the card and on the CPU
    backend of this process; the counter-based RNG makes the paths the
    same, so the images agree to float rounding."""
    import jax

    from tputracer.api import render
    from tputracer.config import RenderConfig
    from tputracer.scene import cornell_box

    cfg = RenderConfig(width=64, height=64, spp=4, max_bounces=4)
    gpu = np.asarray(render(cornell_box("spheres"), cfg)[0])
    cpu_dev = jax.devices("cpu")[0]
    with jax.default_device(cpu_dev):
        img = render(cornell_box("spheres"), cfg)[0]
        if img.devices() != {cpu_dev}:
            raise AssertionError(f"CPU render ran on {img.devices()}")
        cpu = np.asarray(img)
    diff = np.abs(gpu - cpu)
    # radiance is HDR (the light reads 18.4): the bound is absolute up to
    # 1 and relative above, float32 rounding being relative.  The glass
    # sphere refracts: its lens magnifies last-bit differences between
    # the two backends' sqrt and division, so a few pixels seen through
    # it differ by more (on an H100: 1 of 12,288 values at 1.8e-4, 25
    # over 1e-5).  A TF32 product or a wrong kernel moves most pixels.
    over = diff / np.maximum(np.abs(cpu), 1.0)
    worst = np.unravel_index(np.argmax(over), over.shape)
    share = float((over > PIXEL_ATOL).mean())
    rec = {"run": "card_vs_cpu_64", "max_abs_diff": float(diff.max()),
           "max_scaled_diff": float(over.max()), "share_over": share,
           "worst_pixel": [int(i) for i in worst],
           "worst_values": [float(gpu[worst]), float(cpu[worst])],
           "mean_gpu": float(gpu.mean()), "mean_cpu": float(cpu.mean()),
           "ok": bool(share <= PIXEL_SPARE and over.max() <= PIXEL_MAX)}
    if not rec["ok"]:
        raise AssertionError(f"card and CPU renders differ: {rec}")
    return rec


def phase3(plain_means):
    runs = []
    for name in CLI_RUNS:
        rec = run_cli(name)
        rec["cell"] = name
        runs.append(rec)
    with plain_xla():
        scene, cfg, fn = cell("bdpt_caustic")
        plain_means["bdpt_caustic"] = float(
            np.asarray(fn(scene, cfg)[0]).mean())
    for rec in runs:
        plain = plain_means[rec["cell"]]
        rel = abs(rec["mean"] - plain) / abs(plain)
        rec.update(mean_plain=plain, mean_rel_diff=rel)
        if rel > MEAN_RTOL:
            raise AssertionError(f"kernel and plain means differ: {rec}")
    runs.append(run_fit())
    runs.append(card_vs_cpu())
    return runs


# --- --multi: the multi-device paths on four cards -----------------------

def scaled_diff(a, b):
    """max |a - b| per pixel, relative where the reference exceeds 1
    (radiance is HDR; float32 rounding is relative)."""
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))


def run_multi():
    """The multi-device paths on all visible cards, each against its
    one-card (or data-parallel) counterpart; one line per check."""
    import jax
    import jax.numpy as jnp

    from tputracer.api import render
    from tputracer.config import RenderConfig
    from tputracer.dist import (fit_step_sharded, make_mesh,
                                render_bdpt_sharded, render_sharded,
                                render_tiled)
    from tputracer.dist.bdpt_ring import render_bdpt_ring
    from tputracer.fit import _single_step

    n = len(jax.devices())
    mesh = make_mesh((n,), ("dp",))

    def check(rec):
        emit(rec)
        if not rec["ok"]:
            raise AssertionError(f"multi-device check failed: {rec}")

    scene, cfg, _ = cell("pt_cornell")
    err = scaled_diff(np.asarray(render_sharded(scene, cfg, mesh)[0]),
                      np.asarray(render(scene, cfg)[0]))
    check({"multi": "render_sharded", "devices": n,
           "max_scaled_diff": err, "ok": err <= PIXEL_ATOL})

    fcfg = RenderConfig(width=128, height=128, spp=4, max_bounces=3,
                        rr_start=2, chunk_size=1 << 16)
    target = render(scene, fcfg)[0]
    params = {"mat_albedo": scene.mat_albedo * 0.5,
              "mat_emission": scene.mat_emission * 2.0}
    sc = scene.replace(**params)
    ls, gs = fit_step_sharded(sc, params, target, fcfg, mesh)
    l1, g1 = jax.jit(_single_step, static_argnums=(3, 4))(
        sc, params, target, fcfg, "pt")
    rel = max(float(jnp.max(jnp.abs(gs[k] - g1[k]))
                    / jnp.max(jnp.abs(g1[k]))) for k in params)
    rel = max(rel, abs(float(ls) - float(l1)) / abs(float(l1)))
    check({"multi": "fit_step_sharded", "max_rel_diff": rel,
           "ok": rel <= MEAN_RTOL})

    # the tiled ring and its reference, at 4 bounces to bound compile time
    mscene, mcfg, _ = cell("mesh")
    mcfg = mcfg.with_(width=128, height=128, max_bounces=4)
    err = scaled_diff(np.asarray(render_tiled(mscene, mcfg, mesh)[0]),
                      np.asarray(render(mscene, mcfg)[0]))
    check({"multi": "render_tiled", "shards": n, "max_scaled_diff": err,
           "ok": err <= PIXEL_ATOL})

    bscene, bcfg, _ = cell("bdpt_caustic")
    bcfg = bcfg.with_(max_bounces=3)
    ring = np.asarray(render_bdpt_ring(bscene, bcfg, mesh))
    dp = np.asarray(render_bdpt_sharded(bscene, bcfg, mesh))
    # ring BDPT is another estimator of the same image (each eye path
    # connects to n light subpaths): the means agree to Monte-Carlo noise
    rel = float(abs(ring.mean() - dp.mean()) / dp.mean())
    finite = bool(np.isfinite(ring).all())
    check({"multi": "render_bdpt_ring", "mean_ring": float(ring.mean()),
           "mean_dp": float(dp.mean()), "mean_rel_diff": rel,
           "finite": finite, "ok": finite and rel <= 0.05})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--multi", action="store_true",
                    help="run only the multi-device paths (needs 4 GPUs)")
    args = ap.parse_args(argv)
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"   # phase 3's CPU render

    import jax

    from tputracer import compile_cache

    compile_cache.enable()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (platform {dev.platform!r})",
              file=sys.stderr)
        return 1
    count = len(jax.devices())
    smi = nvidia_smi()
    for line in smi:
        print(line, flush=True)
    emit({"phase": 0, "device_kind": dev.device_kind, "count": count,
          "jax": jax.__version__, "nvidia_smi": smi})

    if args.multi:
        if count != 4:
            raise SystemExit(f"--multi needs 4 GPUs, found {count}")
        run_multi()
    else:
        t0 = time.perf_counter()
        cases = kernel_cases()
        checks, arrays = phase1(cases)
        emit({"phase": 1, "checks": checks,
              "wall_s": time.perf_counter() - t0})
        t0 = time.perf_counter()
        calls = phase2_calls(cases, arrays)
        del arrays
        renders = phase2_renders()
        emit({"phase": 2, "calls": calls, "renders": renders,
              "wall_s": time.perf_counter() - t0})
        t0 = time.perf_counter()
        plain_means = {r["cell"]: r["mean_plain"] for r in renders}
        runs = phase3(plain_means)
        emit({"phase": 3, "runs": runs, "wall_s": time.perf_counter() - t0})
    emit({"ok": True, "device": {"platform": dev.platform,
                                 "kind": dev.device_kind, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
