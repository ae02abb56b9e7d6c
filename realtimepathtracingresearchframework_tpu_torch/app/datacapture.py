"""Data-capture POI sampling + viewpoint generation via ray queries.

Reconstructs the ``rt_datacapture`` surface used by the reference's data
capture tools (libapp/data_capture_state.h:18-86, app.cpp:298-309):
``collect_visible_points`` / ``prune_pois`` / ``sample_viewpoint``. The
``libdatacapture`` implementation itself is not in the public release —
only its call sites — so the semantics here follow those call sites: POIs
are scene surface points collected by shooting visibility rays from
perspective anchors; pruning bounds and de-duplicates the set; viewpoint
sampling produces an unoccluded (pos, dir) camera placement that looks at
a POI, used both for interactive camera placement and for denoiser
training-set captures.

All tracing goes through ``Renderer.render_ray_queries`` (the RQ_CLOSEST
kernel, vulkan/rt_intersect.comp:31-68): in the port, the scene's route
kernel (K1 on cornell) on a card. The module is the reference's
``app/datacapture.py`` over the port's renderer; its sampling is numpy
from an explicit ``numpy.random.Generator``, so both give the same POIs
and views from the same seed and the same hits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class Poi:
    """A point of interest on scene geometry (rt_datacapture::Poi)."""

    position: np.ndarray  # (3,)
    normal_hint: np.ndarray  # (3,) direction it was discovered from (unit)


@dataclass
class View:
    """rt_datacapture::View — a generated capture camera."""

    pos: np.ndarray  # (3,)
    dir: np.ndarray  # (3,) unit


def _uniform_sphere(rng: np.random.Generator, n: int) -> np.ndarray:
    z = rng.uniform(-1.0, 1.0, n)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    return np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=-1)


def collect_visible_points(
    renderer,
    source: np.ndarray,
    count: int,
    rng: Optional[np.random.Generator] = None,
) -> List[Poi]:
    """Shoot ``count`` uniformly distributed rays from ``source`` and
    collect the hit points as POIs (rt_datacapture::collect_visible_points
    call shape, data_capture_state.h:54). Misses are dropped, so the
    result may be shorter than ``count``."""
    rng = rng or np.random.default_rng(0)
    source = np.asarray(source, np.float32)
    dirs = _uniform_sphere(rng, count).astype(np.float32)
    origins = np.broadcast_to(source, dirs.shape).copy()
    t, tri, _u, _v = renderer.render_ray_queries(origins, dirs)
    hit = np.asarray(tri) >= 0
    pts = origins[hit] + np.asarray(t)[hit, None] * dirs[hit]
    return [Poi(position=p, normal_hint=-d) for p, d in zip(pts, dirs[hit])]


def prune_pois(
    renderer,
    pois: List[Poi],
    rng: Optional[np.random.Generator] = None,
    min_separation: float = 1e-3,
    max_pois: Optional[int] = None,
) -> List[Poi]:
    """Bound and de-duplicate the POI set (rt_datacapture::prune_pois call
    shape, data_capture_state.h:57): shuffle with ``rng``, drop points
    closer than ``min_separation`` to an already-kept point (grid hash),
    keep at most ``max_pois``. Returns the pruned list (the reference
    resizes in place and returns the new count)."""
    rng = rng or np.random.default_rng(0)
    if not pois:
        return []
    order = rng.permutation(len(pois))
    cell = max(min_separation, 1e-12)
    # grid hash with a 27-neighborhood distance check: same-cell-only
    # dedup keeps near-duplicates that straddle a cell boundary
    seen: dict = {}
    kept: List[Poi] = []
    for i in order:
        p = pois[int(i)]
        pos = np.asarray(p.position, np.float64)
        key = tuple(np.floor(pos / cell).astype(np.int64))
        close = False
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    for q in seen.get(
                        (key[0] + dx, key[1] + dy, key[2] + dz), ()
                    ):
                        if np.linalg.norm(pos - q) < min_separation:
                            close = True
                            break
                    if close:
                        break
                if close:
                    break
            if close:
                break
        if close:
            continue
        seen.setdefault(key, []).append(pos)
        kept.append(p)
        if max_pois is not None and len(kept) >= max_pois:
            break
    return kept


def sample_viewpoint(
    renderer,
    pois: List[Poi],
    rng: Optional[np.random.Generator] = None,
    min_dist: float = 0.1,
    max_dist: float = 10.0,
    tries: int = 16,
) -> View:
    """Generate an unoccluded camera placement looking at a random POI
    (rt_datacapture::sample_viewpoint, app.cpp:303-307): pick a POI, walk
    outward along a random direction biased toward the discovery side,
    clamp the eye to stay in free space (the first occluder wins), aim at
    the POI."""
    rng = rng or np.random.default_rng(0)
    if not pois:
        raise ValueError("sample_viewpoint: empty POI set")
    eps = 1e-3
    for _ in range(tries):
        poi = pois[int(rng.integers(len(pois)))]
        d = _uniform_sphere(rng, 1)[0]
        if np.dot(d, poi.normal_hint) < 0.0:
            d = -d  # leave the surface on its visible side
        want = float(rng.uniform(min_dist, max_dist))
        o = (poi.position + eps * d).astype(np.float32)[None]
        t, tri, _u, _v = renderer.render_ray_queries(
            o, d.astype(np.float32)[None]
        )
        free = want if tri[0] < 0 else min(want, float(t[0]) * 0.9)
        if free < min_dist:
            continue  # too cramped, try another POI
        pos = poi.position + free * d
        look = poi.position - pos
        n = np.linalg.norm(look)
        return View(pos=pos.astype(np.float32),
                    dir=(look / max(n, 1e-20)).astype(np.float32))
    # fall back to the last candidate even if cramped
    pos = poi.position + max(free, eps) * d
    look = poi.position - pos
    return View(pos=pos.astype(np.float32),
                dir=(look / max(np.linalg.norm(look), 1e-20)).astype(np.float32))


def generate_capture_views(
    renderer,
    perspectives: List[np.ndarray],
    num_pois_per_perspective: int = 1000,
    num_views: int = 8,
    seed: int = 0,
    min_dist: float = 0.1,
    max_dist: float = 10.0,
) -> List[View]:
    """End-to-end viewpoint generation: collect POIs from each perspective
    anchor, prune, then sample ``num_views`` camera placements — the
    "Regenerate POIs" + place-capture-camera flow of
    data_capture_state.h:48-58 / app.cpp:298-309 as one headless call."""
    rng = np.random.default_rng(seed)
    pois: List[Poi] = []
    for src in perspectives:
        pois.extend(
            collect_visible_points(renderer, src, num_pois_per_perspective, rng)
        )
    pois = prune_pois(renderer, pois, rng)
    return [
        sample_viewpoint(renderer, pois, rng, min_dist, max_dist)
        for _ in range(num_views)
    ]


def capture_poi_radiance(
    renderer,
    pois: List[Poi],
    spp_per_query: int = 16,
    variant: Optional[str] = None,
    params=None,
) -> np.ndarray:
    """Incident-radiance capture at POIs via FULL-INTEGRATOR ray queries
    (render_vulkan.cpp:1867-1877; per-query progressive accumulation,
    accumulate.glsl:31-42): each POI is queried along its discovery
    direction with ``spp_per_query`` integrator samples. Returns an
    (N, 4) float32 RGBA radiance array — the denoiser-training radiance
    target the reference captures through this path."""
    from realtimepathtracingresearchframework_tpu_torch.backend.renderer import (
        VARIANT_MEGAKERNEL,
    )

    if not pois:
        return np.zeros((0, 4), np.float32)
    eps = 1e-3
    origins = np.stack(
        [p.position + eps * p.normal_hint for p in pois]
    ).astype(np.float32)
    dirs = np.stack([-p.normal_hint for p in pois]).astype(np.float32)
    return renderer.render_ray_queries(
        origins, dirs,
        variant=variant or VARIANT_MEGAKERNEL,
        spp_per_query=spp_per_query,
        params=params,
    )
