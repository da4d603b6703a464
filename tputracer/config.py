"""Frozen, hashable configs — static jit arguments (SURVEY.md §5 "Config").

Shape-affecting knobs (resolution, spp, bounces, chunk size) live here so
changing them recompiles cleanly; everything runtime-valued lives in the
Scene pytree.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class RenderConfig:
    width: int = 512
    height: int = 512
    spp: int = 16
    max_bounces: int = 4          # scatter events; total path verts = +1
    rr_start: int = 3             # first bounce with Russian roulette
    seed: int = 0
    mis: bool = False             # False = NEE-only (reference semantics,
                                  # SURVEY.md §3.2); True = power-heuristic
                                  # MIS between NEE and BSDF sampling
    chunk_size: int = 1 << 20     # wavefront paths per chunk (memory knob)
    transport_radiance: bool = True
    remat: bool = False           # jax.checkpoint each bounce: backward
                                  # stores only the per-bounce carry
                                  # (o,d,thr,L,masks ~ 13 floats/path)
                                  # and recomputes bounce internals —
                                  # trades forward FLOPs for backward
                                  # memory traffic in inverse rendering.
                                  # Primal math is identical (same step
                                  # function either way).  Off until
                                  # measured on the card; correctness is
                                  # covered by tests/unit/test_grad.py.
    sort_rays: bool = False       # M5: re-sort the wavefront by (alive,
                                  # direction octant, origin cell) each
                                  # bounce; off until measured on the
                                  # card against the per-ray traversal.

    def with_(self, **kw):
        return replace(self, **kw)


@dataclass(frozen=True)
class BdptConfig:
    """Bidirectional path tracer config (SURVEY.md §3.3).

    ``max_bounces`` mirrors RenderConfig: a full path has at most
    ``max_bounces + 2`` vertices including the camera, so PT and BDPT
    with equal ``max_bounces`` integrate the same path space — the
    PT<->BDPT convergence tests (SURVEY.md §4 item 3) rely on this.
    """
    width: int = 512
    height: int = 512
    spp: int = 16
    max_bounces: int = 4          # max surface scatter events on a full path
    seed: int = 0
    chunk_size: int = 1 << 16
    transport_radiance: bool = True
    mis_power: bool = False       # False = balance heuristic; True =
                                  # Veach power heuristic (beta=2).
                                  # SURVEY §3.3 describes the reference
                                  # as power-heuristic but the mount is
                                  # empty (SURVEY §0): default stays
                                  # balance until a re-survey settles it.

    def with_(self, **kw):
        return replace(self, **kw)


@dataclass(frozen=True)
class DistConfig:
    """Device-mesh layout for multi-chip / multi-host rendering."""
    axis_name: str = "rays"
    num_devices: int = 1          # 1 = single-device (no shard_map)
