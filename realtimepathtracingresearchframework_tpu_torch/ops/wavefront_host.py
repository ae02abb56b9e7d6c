"""Bounce-major wavefront executor (PyTorch).

Counterpart of the reference's ``ops/wavefront_host.py``. The monolithic
pass (``integrator.make_pass_fn``) runs the whole bounce loop for one chunk
of lanes; this executor runs the frame bounce by bounce instead, with the
host as the queue manager:

  bounce 0   camera rays for the WHOLE frame (every chunk at once), visit
             (K2 on the unsorted, swizzle-coherent primaries) and scatter
             (the NEE shadow queue sorted by its own origins, K3), then a
             stable live-first coherence sort of the carry and its live
             count;
  bounce b   on the live head [0, w) of the sorted carry, w the smallest
             ladder width covering the live count: visit with the lanes
             presorted (K3), scatter with a sorted shadow queue (K3), and
             the head re-sorted live-first. The dead tail rides along;
  resolve    illum, alpha and rays gathered back to lane order;
  accumulate the progressive blend of each chunk's lanes into the
             renderer's planar accumulators (``integrator.blend_sample``,
             as the monolith blends).

Between bounces the host reads back one number, the live count, to pick
the next width (``host_read("executor_live")``). The carry stays a tuple
of tensors, permuted by plain indexing: the reference's packing into one
int32 buffer and its jit programs exist for the TPU and have no
counterpart here.

Every per-lane operation of visit and scatter is elementwise over lanes
(the RNG state rides the carry) and traversal is exact under any lane
order, so the path structure is the monolith's, lane for lane.
"""

from __future__ import annotations

import torch

from realtimepathtracingresearchframework_tpu_torch.ops import integrator as intg
from realtimepathtracingresearchframework_tpu_torch.ops import pointsets
from realtimepathtracingresearchframework_tpu_torch.ops.rng import M32
from realtimepathtracingresearchframework_tpu_torch.ops.traverse_resident import (
    inverse_permutation,
)
from realtimepathtracingresearchframework_tpu_torch.utils.profiling import (
    host_read,
    span,
)

# dispatch-width ladder quantum (wavefront_host.py:67): whole multiples of
# the kernels' 1024-lane blocks, at most ~12% padding at real live counts
LADDER_QUANTUM = 262144


def ladder_cover(ladder, live):
    """Smallest ladder width >= live (ladder ascends; live <= ladder[-1])."""
    for w in ladder:
        if live <= w:
            return w
    return ladder[-1]


def make_ladder(n_total: int) -> tuple:
    """The dispatch widths of a frame of ``n_total`` lanes
    (wavefront_host.py:143-152): power-of-two rungs below the quantum for
    the roulette tail, then multiples of the quantum up to the frame."""
    small = tuple(
        w for w in (32768, 65536, 131072)
        if w < min(LADDER_QUANTUM, n_total)
    )
    big = tuple(range(LADDER_QUANTUM, n_total + 1, LADDER_QUANTUM))
    return small + (big or (n_total,))


class WavefrontExecutor:
    """The executor for one (scene, config, resolution). ``px``, ``py`` and
    ``valid`` are the whole frame's swizzled lanes (every chunk,
    concatenated) on the scene's device; ``chunk`` is the accumulators'
    chunk length."""

    def __init__(self, ds, cfg, width: int, height: int, px, py, valid,
                 chunk: int):
        if cfg.debug_mode or cfg.wavefront:
            raise ValueError("wavefront executor: debug counters and the "
                             "wavefront variant keep the monolith")
        # the executor sorts the carry itself: per-dispatch and carry
        # compaction are superseded (wavefront_host.py:154)
        self.cfg = cfg._replace(compact=False, compact_lanes=False)
        intg.check_supported(self.cfg)
        self.ds = ds
        self.width, self.height = width, height
        self.px, self.py, self.valid = px, py, valid
        self.chunk = chunk
        self.n_total = px.shape[0]
        self.depth = int(cfg.max_path_depth)
        self.ladder = make_ladder(self.n_total)
        self.lo, self.hi = intg._scene_bounds_of(ds)
        self.live_profile = []  # live lanes after each bounce, last sample

    def _sort_live_first(self, carry, lane_id):
        """Span ``rptr.sort``: the live-first sort and the live count, read
        by the host (``host_read("executor_live")``)."""
        with span("rptr.sort"):
            key = intg._carry_coherence_key(carry.ro, carry.rd, carry.active,
                                            self.lo, self.hi)
            perm = torch.argsort(key, stable=True)
            return (intg._permute_lanes(carry, perm), lane_id[perm],
                    host_read("executor_live", carry.active.sum()))

    def render_sample(self, fp, view, accs, s: int, blend_base: int):
        """One sample over the whole frame, bounce-major, blended into the
        per-chunk accumulators ``accs`` in place (span ``rptr.pass``, the
        bounces' ``rptr.bounce.<b>``, ``rptr.camera`` and ``rptr.blend``).
        Returns the sample's traced rays (a device scalar)."""
        with span("rptr.pass"):
            cfg, dev = self.cfg, self.px.device
            visit_hit, scatter_tail = intg._make_bounce_fns(self.ds, cfg, fp)
            with span("rptr.camera"):
                state = pointsets.make_state(
                    cfg.rng_variant, (fp.sample_offset + s) & M32, fp.shot_offset,
                    self.px, self.py, self.width, bufs=self.ds.rng,
                )
                dims = (float(self.width), float(self.height))
                state, ro, rd = intg.camera_setup(cfg, view, self.px, self.py,
                                                  dims, state, bufs=self.ds.rng,
                                                  fp=fp)
                # textured scenes: the camera footprint seeds the carry
                # (wavefront_host.py:179-181)
                carry = intg.initial_carry(
                    ro, rd, state, self.valid,
                    foot=intg.camera_footprint0(cfg, fp, view, dims, rd))
                lane_id = torch.arange(self.n_total, device=dev)

            with span("rptr.bounce", 0):
                carry, ctx = visit_hit(carry)
                if self.depth > 1:
                    carry = scatter_tail(carry, ctx, 0, sort_shadow=True)
                carry, lane_id, live = self._sort_live_first(carry, lane_id)
            profile = [live]
            for b in range(1, self.depth):
                if live == 0:
                    break
                with span("rptr.bounce", b):
                    w = ladder_cover(self.ladder, live)
                    head = intg._map_lanes(lambda a: a[:w], carry)
                    head, ctx = visit_hit(head, presorted=True)
                    if b < self.depth - 1:
                        head = scatter_tail(head, ctx, b, sort_shadow=True)
                    head, head_id, live = self._sort_live_first(head, lane_id[:w])
                    with span("rptr.sort"):
                        if w == self.n_total:
                            carry, lane_id = head, head_id
                        else:
                            carry = intg._map_lanes(
                                lambda h, a: torch.cat([h, a[w:]]), head, carry)
                            lane_id = torch.cat([head_id, lane_id[w:]])
                profile.append(live)
            self.live_profile = profile

            # resolve to lane order, then the per-chunk blend
            with span("rptr.blend"):
                inv = inverse_permutation(lane_id)
                rgb = [c[inv] for c in carry.illum]
                alpha = torch.where(carry.bounce_count[inv] == 0, 0.0, 1.0)
                for c, acc in enumerate(accs):
                    sl = slice(c * self.chunk, (c + 1) * self.chunk)
                    intg.blend_sample(acc, (rgb[0][sl], rgb[1][sl], rgb[2][sl],
                                            alpha[sl]),
                                      self.valid[sl], blend_base + s)
                return carry.rays.sum()
