"""Benchmark suite over the BASELINE measurement configs (BASELINE.md).

Needs a GPU.  Each benchmark jits, warms up, then reports the median of N
timed reps, each ending in block_until_ready.  Output: one JSON line per
config, written to stdout and appended to benchmarks/results.jsonl; every
record names the device it ran on (platform, device kind and count, and
the card's name and power limit from nvidia-smi).

    python -m benchmarks.run [--quick] [--only pt_cornell,mesh]

rays/s counts (bounces + 1) closest-hit + bounces shadow rays per path,
the flat upper bound; the rays actually traced (live lanes) are reported
alongside.  BDPT counts subpath segments + one shadow ray per connection
strategy.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def _timed(fn, reps=5):
    """Median seconds over reps blocking runs, after two warm-up runs."""
    _fetch(fn())
    _fetch(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        jaxify(out)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def nvidia_smi():
    """'<name>, <power limit>' per card, from nvidia-smi (a child process
    that stays off JAX)."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()


def device_record():
    """The device a record was measured on.  Exits non-zero without a
    GPU: no number from another backend is recorded as a device metric."""
    import sys

    import jax

    from tputracer import compile_cache

    compile_cache.enable()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"benchmarks.run: no GPU (platform {dev.platform!r})",
              file=sys.stderr)
        raise SystemExit(1)
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices()), "nvidia_smi": nvidia_smi()}


def _fetch(x):
    import jax

    for leaf in jax.tree.leaves(x):
        np.asarray(leaf)


def jaxify(x):
    import jax

    jax.block_until_ready(x)


def _issued(stats):
    """Honest live-lane ray count from the integrator's per-bounce stats
    (BASELINE.md protocol: reported alongside the flat upper bound)."""
    return round(float(np.asarray(stats["rays_closest"]).sum()
                       + np.asarray(stats["rays_shadow"]).sum()))


def _pt_bench(scene, cfg, reps=5):
    dt = _timed(lambda: render_fn()(scene, cfg)[0], reps=reps)
    _, stats = render_fn()(scene, cfg)
    paths = cfg.width * cfg.height * cfg.spp
    rays = paths * (cfg.max_bounces + 1 + cfg.max_bounces)
    issued = _issued(stats)
    return {"rays_per_s": rays / dt, "render_s": dt,
            "rays_issued": issued,
            "issued_rays_per_s": issued / dt}


def render_fn():
    from tputracer.api import render

    return render


def bench_pt_cornell(quick):
    """Config 1: Cornell box, unidirectional PT, 4 bounces, 16 spp, 512^2."""
    from tputracer.config import RenderConfig
    from tputracer.scene import cornell_box

    size = 256 if quick else 512
    scene = cornell_box("boxes")
    cfg = RenderConfig(width=size, height=size, spp=16, max_bounces=4)
    out = _pt_bench(scene, cfg)
    out["paths"] = size * size * cfg.spp
    return out


def bench_cornell_glass(quick):
    """Config 2: Cornell + glass/mirror spheres, RR, 64 spp."""
    from tputracer.config import RenderConfig
    from tputracer.scene import cornell_box

    size = 128 if quick else 256
    scene = cornell_box("spheres")
    cfg = RenderConfig(width=size, height=size, spp=64, max_bounces=6,
                       rr_start=3)
    return _pt_bench(scene, cfg)


def bench_mesh(quick):
    """Config 3: ~100k-tri mesh, PT 8 bounces, cluster-BVH traversal."""
    from tputracer.config import RenderConfig
    from tputracer.scene import mesh_scene

    scene = mesh_scene(subdiv=4 if quick else 6)
    size = 64 if quick else 256
    # the whole frame (262,144 paths) in one chunk, as the CLI renders it
    cfg = RenderConfig(width=size, height=size, spp=4, max_bounces=8,
                       rr_start=3)
    out = _pt_bench(scene, cfg, reps=3)
    out.update(n_tris=scene.n_tris, n_clusters=scene.n_clusters)
    return out


def bench_mesh_tiled(quick):
    """Config-3 mesh scene with the GEOMETRY tiled over the device mesh
    and rays ring-rotated past every shard (dist.scene_shard).  On one
    GPU the ring degenerates to one hop, so the row measures the tiled
    code path (local traversal kernel per hop + ring carry) rather than
    scaling; multi-shard correctness is covered by the 8-virtual-device
    CPU tests (tests/distributed/test_scene_tiling.py)."""
    import jax

    from tputracer.config import RenderConfig
    from tputracer.dist import make_mesh
    from tputracer.dist.scene_shard import render_tiled
    from tputracer.scene import mesh_scene

    scene = mesh_scene(subdiv=4 if quick else 6)
    size = 64 if quick else 256
    cfg = RenderConfig(width=size, height=size, spp=4, max_bounces=8,
                       rr_start=3)
    mesh = make_mesh((len(jax.devices()),), ("dp",))
    dt = _timed(lambda: render_tiled(scene, cfg, mesh)[0], reps=3)
    _, stats = render_tiled(scene, cfg, mesh)
    paths = size * size * cfg.spp
    rays = paths * (cfg.max_bounces + 1 + cfg.max_bounces)
    issued = _issued(stats)
    return {"rays_per_s": rays / dt, "render_s": dt,
            "rays_issued": issued,
            "issued_rays_per_s": issued / dt,
            "n_tris": scene.n_tris, "n_clusters": scene.n_clusters,
            "n_shards": len(jax.devices())}


def bench_bdpt_caustic(quick):
    """Config 4: BDPT with vertex connection + MIS on the caustics scene."""
    from tputracer.api import render_bdpt
    from tputracer.config import BdptConfig
    from tputracer.scene import cornell_box

    size = 64 if quick else 128
    scene = cornell_box("caustic")
    cfg = BdptConfig(width=size, height=size, spp=8, max_bounces=4,
                     chunk_size=1 << 15)
    cell = {}

    def run():
        img, cell["stats"] = render_bdpt(scene, cfg)
        return img

    dt = _timed(run, reps=3)   # stats captured from the last timed rep
    stats = cell["stats"]      # (no fourth un-timed render)
    paths = size * size * cfg.spp
    B = cfg.max_bounces
    E = B + 1
    # 2 subpath walks of E segments + ~(strategies) shadow rays per path
    n_strat = sum(1 for t in range(1, E + 2) for s in range(0, E + 1)
                  if 2 <= s + t <= B + 2 and not (s == 0 and t < 2))
    rays = paths * (2 * E + n_strat)
    issued = _issued(stats)   # exact live-lane counters
    return {"rays_per_s": rays / dt, "render_s": dt,
            "rays_issued": issued,
            "issued_rays_per_s": issued / dt,
            "strategies": n_strat}


def bench_inverse(quick):
    """Config 5: inverse-rendering step (render + grad + psum + update)."""
    import jax
    import optax

    from tputracer.config import RenderConfig
    from tputracer.dist import fit_step_sharded, make_mesh, render_sharded
    from tputracer.scene import cornell_box

    size = 64 if quick else 128
    mesh = make_mesh()
    scene = cornell_box("boxes")
    cfg = RenderConfig(width=size, height=size, spp=4, max_bounces=3,
                       rr_start=2, chunk_size=1 << 16)
    target, _ = render_sharded(scene, cfg, mesh)
    target = jax.block_until_ready(target)
    params = {"mat_albedo": scene.mat_albedo * 0.5,
              "mat_emission": scene.mat_emission * 2.0}
    opt = optax.adam(1e-2)
    opt_state = opt.init(params)
    sc = scene.replace(**params)

    from tputracer.dist import fit_chain_sharded

    K = 8   # optimization steps per dispatch; kept until measured on the
            # card against single-step dispatch

    # the state is chained across timed dispatches (optimizer outputs
    # feed the next call) and every dispatch ends in one fetch of the
    # loss vector
    p, st = params, opt_state
    # warm-up: compile + the one sharding-driven recompile when outputs
    # first feed back as inputs
    for _ in range(2):
        ls, p, st = fit_chain_sharded(sc.replace(**p), p, target, cfg,
                                      mesh, opt, st, K)
        np.asarray(ls)
    n_disp = 6
    t0 = time.perf_counter()
    for _ in range(n_disp):
        ls, p, st = fit_chain_sharded(sc.replace(**p), p, target, cfg,
                                      mesh, opt, st, K)
        np.asarray(ls)             # real fetch: the only trustworthy sync
    dt = (time.perf_counter() - t0) / n_disp
    paths = size * size * cfg.spp
    rays = K * paths * (cfg.max_bounces + 1 + cfg.max_bounces)
    return {"steps_per_s": K / dt,
            "steps_per_dispatch": K,
            "chained_protocol": True,
            "fwd_bwd_rays_per_s": rays / dt,
            "n_devices": len(jax.devices())}


BENCHES = {
    "pt_cornell": bench_pt_cornell,
    "cornell_glass": bench_cornell_glass,
    "mesh": bench_mesh,
    "mesh_tiled": bench_mesh_tiled,
    "bdpt_caustic": bench_bdpt_caustic,
    "inverse": bench_inverse,
}


_METRIC = {"inverse": "steps_per_s"}   # default metric: rays_per_s


def _load_records(out_path):
    records = []
    with open(out_path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def _check_regressions(out_path, names, tol=0.10, recent=3):
    """SURVEY.md §4.6: fail (exit 1) if none of the newest `recent` runs
    of a config comes within tol of the best prior same-mode record.

    Best-of-recent, not last-only: one slow process is not a regression;
    a real regression shows up in every recent run."""
    records = _load_records(out_path)
    failed = False
    for name in names:
        metric = _METRIC.get(name, "rays_per_s")
        hist = [r for r in records
                if r.get("bench") == name and not r.get("quick")
                and metric in r and not r.get("note")]
        # compare like with like: only records sharing the freshest
        # record's protocol (a chained-dispatch inverse row must not be
        # judged against single-step-era rows, and vice versa)
        if hist:
            hist = [r for r in hist if _same_protocol(r, hist[-1])]
        if len(hist) < 2:
            print(f"check {name}: no comparable prior record, skipped")
            continue
        k = min(recent, len(hist) - 1)
        fresh = max(r[metric] for r in hist[-k:])
        prior = max(r[metric] for r in hist[:-k])
        ratio = fresh / prior
        verdict = "OK" if ratio >= 1.0 - tol else "REGRESSION"
        print(f"check {name}: best-of-{k}-recent {fresh:.4g} vs best "
              f"prior {prior:.4g} ({ratio:.2%}) {verdict}")
        failed |= verdict == "REGRESSION"
    return 1 if failed else 0


# record keys that define the measurement protocol: records disagreeing
# on any of these are not comparable (a chained-dispatch inverse row must
# not be judged against single-step rows, a 4-card row against a 1-card
# row, one card against another)
_PROTOCOL_KEYS = ("steps_per_dispatch", "n_tris", "n_shards",
                  "chained_protocol", "device_kind", "device_count")


def _same_protocol(a, b):
    return all(a.get(k) == b.get(k) for k in _PROTOCOL_KEYS)


def _outlier_guard(out_path, name, rec, note, factor=3.0):
    """Ledger hygiene: refuse to append a record whose metric is >factor
    off the median of prior same-config, same-protocol records unless it
    carries a note explaining it, so an unexplained outlier never enters
    the regression baseline."""
    metric = _METRIC.get(name, "rays_per_s")
    if note:
        # an explicit --note is always recorded, in-band or not: a row
        # the user flagged as suspect must not enter the baseline series
        # unannotated (noted rows are excluded from medians and checks)
        rec["note"] = note
    if metric not in rec:
        return True
    if rec.get("quick"):
        # quick runs use smaller sizes — not comparable to the full-size
        # median (prior filter excludes quick rows anyway); never refuse
        return True
    try:
        prior = [r[metric] for r in _load_records(out_path)
                 if r.get("bench") == name and not r.get("quick")
                 and metric in r and not r.get("note")
                 and _same_protocol(r, rec)]
    except FileNotFoundError:
        return True
    if len(prior) < 2:
        return True
    med = float(np.median(prior[-5:]))   # recency window: current-code era
    v = rec[metric]
    if med / factor <= v <= med * factor:
        return True
    if note:
        return True          # already annotated above
    print(f"REFUSING to append {name}: {metric}={v:.4g} is >{factor}x "
          f"off the prior median {med:.4g} and no --note was given. "
          f"Re-run with --note '<explanation>' to record it anyway.")
    return False


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", default=None,
                    help="comma-separated subset of: " + ",".join(BENCHES))
    ap.add_argument("--check", action="store_true",
                    help="after running, exit 1 on >10%% regression vs the "
                         "best prior results.jsonl record per config")
    ap.add_argument("--note", default=None,
                    help="annotation recorded with the result; REQUIRED "
                         "when the metric lands >3x off the prior median")
    args = ap.parse_args(argv)
    names = args.only.split(",") if args.only else list(BENCHES)
    out_path = os.path.join(os.path.dirname(__file__), "results.jsonl")

    if len(names) > 1:
        # one child process per bench, one at a time: this parent never
        # imports JAX, so only one process holds the card
        import subprocess
        import sys

        bad = False
        for name in names:
            cmd = [sys.executable, "-m", "benchmarks.run", "--only", name]
            if args.quick:
                cmd.append("--quick")
            if args.note:
                cmd += ["--note", args.note]
            # any abnormal subprocess exit fails the check: a refused
            # outlier (rc 3) AND a crashed bench (OOM/compile error) —
            # a crash is a stronger anomaly than an outlier, and without
            # a fresh row _check_regressions would pass on stale history
            bad |= subprocess.run(cmd, check=False).returncode != 0
        if args.check:
            raise SystemExit(1 if bad
                             else _check_regressions(out_path, names))
        return

    name = names[0]
    rec = {"bench": name, "quick": args.quick, **device_record()}
    rec.update(BENCHES[name](args.quick))
    ok = _outlier_guard(out_path, name, rec, args.note)
    line = json.dumps(rec)
    print(line, flush=True)
    if ok:
        with open(out_path, "a") as fh:
            fh.write(line + "\n")
    if args.check:
        # a refused (>3x-off) record IS a failed check: without this, the
        # check would read only healthy prior rows and pass precisely on
        # the largest anomalies
        rc = _check_regressions(out_path, [name])
        raise SystemExit(1 if not ok else rc)
    if not ok:
        raise SystemExit(3)   # refusal marker for the multi-bench parent


if __name__ == "__main__":
    main()
