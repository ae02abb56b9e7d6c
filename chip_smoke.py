#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and ``nvcc`` (on PATH or under $CUDA_HOME/bin), and exits
non-zero, printing no result, without them or outside a checkout.

Phases (each raises on failure):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: the nine traversal kernels from their eight sources and the
     two fused shading kernels from theirs, one nvcc each, all at once: K1
     (csrc/traverse_resident.cu), K2 (csrc/traverse_flat_cull.cu), K3
     (csrc/traverse_precull.cu), K4 (csrc/traverse_streamed.cu), K5
     (csrc/traverse_binned.cu), K6 (csrc/traverse_tlas.cu), K7
     (csrc/traverse_tlas_stream.cu), K8a and K8b (csrc/traverse_v1.cu),
     shade_hit and shade_scatter (csrc/shade.cu), with nvcc's registers
     and spills of every instance;
  3. the cornell main path: 1920x1080, 1 spp, depth 9, one warm-up frame
     and timed frames; K1 must launch, K2-K5 not;
  3b. the village path: procedural.village(), 80,496 textured triangles, at
     1920x1080, 1 spp, depth 9, with bench.py's village camera, sun and sky,
     through K2, K3 and the wavefront executor: set-up seconds, one warm-up
     frame and timed frames (ms, Mray/s, alpha hops per frame); K2 and K3
     must launch, K1 and K4-K7 not; then the share of base-colour lookups
     whose mip level differs between the card and the CPU on one chunk
     (bounces 0 and 1);
  3c. the cornell main path through the PT_WAVEFRONT variant, timed as 3:
     every K1 launch is a merged two-queue launch (the bounce's closest
     queue and the previous bounce's deferred shadow queue), so K1 launches
     no separate any-hit; one frame of sample 0 held against the
     PT_MEGAKERNEL frame of the same sample: equal ray counts and
     goldens.compare_card;
  3d. the cornell main path under the BN, Sobol and Z-Sobol RNG variants
     (options.rng_variant, the reference's pointset tables): timed frames
     as in 3, the device kernels of one profiled 960x544 frame (one chunk)
     beside the uniform variant's; K1 must launch and no other;
  3e. the village through PT_WAVEFRONT, the monolith with its default
     carry compaction: timed frames with each compacted bounce's live
     lanes and prefix; sample 0 with compaction against
     RPTR_COMPACT_LANES=0 (equal rays, bitwise or within rtol 3e-5 / atol
     1e-7, printed); K2 and K3 against their plain versions and K1 on the
     first compacted queue; K2 and K3 must launch and no other;
  3f. the fused shading kernels (csrc/shade.cu, shade_hit and
     shade_scatter) against their plain versions on the bounce-0 and
     bounce-1 carries of chunk 2 of the 1080p sample 0 of each case of
     SHADE_CASES: the village (textured) and terrain500 (untextured), the
     village under RIS and in the wavefront variant, cornell with a glass
     material with the sun and sky off and in the glossy-only mode: per
     kernel and bounce the fields that differ, with their lanes and
     largest difference (none may: SHADE_LANES_OFF), the kernel-only ms
     beside the bytes bound and the plain version's ms, and the wrappers'
     launch counts;
  4. the terrain200 path: procedural.terrain(grid=200), 80,000 tris, at
     1920x1080, 1 spp, depth 9, through the wavefront executor: one
     warm-up frame and timed frames; K2 and K3 must launch, K1, K4, K5 not;
  5. the terrain500 paths: procedural.terrain(grid=500), 500,000 tris, on
     the streamed route (monolithic pass, K4 for closest hits, K5 for
     shadow rays), at 1920x1080, 1 spp, depth 9 and at the bench's
     512x384, 1 spp, depth 3: the pack's set-up seconds, one warm-up frame
     and timed frames; K4 and K5 must launch, K1-K3 not (every count is
     set to 0 just before each path and read just after; the timed paths
     run first, before the plain versions and the CPU renders load the
     host);
  5a. this slice's streamed paths at 1920x1080, 1 spp, depth 9: terrain500
     with 16-bit quantized tiles (options.quantized_geometry; set-up
     seconds, tile bytes of the f32 and int16 packs), the sorted K4 walk and
     one binned K5 round on int16 tiles; the f32 terrain500 through K4's
     ordered walk (RPTR_STREAM_CLOSEST=ordered) and the quantized one
     through the multislot dispatch (RPTR_STREAM_CLOSEST=multislot; K4 and
     K5 launches per frame, the share of rays past its 8 slots); K4 and K5
     must launch, K1-K3 and K6-K7 not;
  5b. the instanced paths, two-level (options.use_tlas), with a TLAS update
     (set_animation_frame) before every frame as bench.py's instanced row
     does: procedural.instanced_field(num_inst=600), 601 instances of four
     meshes, through K7 at the bench's 512x384, 1 spp, depth 3, 8 frames,
     and at 1920x1080, 1 spp, depth 9; instanced_field(num_inst=500), 501
     instances, through K6 at 1920x1080, 1 spp, depth 9: set-up seconds,
     TLAS update ms, frame ms, Mray/s; the path's kernel must launch and
     no other;
  5c. instanced500 1080p depth 9 through K6's ordered instance walk (a TLAS
     update before every frame), and instanced_field(num_inst=2500), 2,501
     (instance, chunk) entries past the reference's cap of 2,048, through
     K7 at 1080p depth 9 (the entry count and K7's mode, staged or global,
     printed). Every timed path (3-5c) also prints Renderer.stats()'s
     render time beside the script's CUDA-event time, and its last frame's
     display image (readback_framebuffer, Reinhard-tonemapped) must be
     finite and in [0, 1];
  5e. animated flattened scenes (options.use_tlas off), a BVH update
     before every frame: procedural.instanced_field(num_inst=600), 567,104
     tris on the streamed route, refit past the rebuild budget, at the
     bench's 512x384 depth 3, 4 frames; instanced_field(num_inst=100),
     78,086 tris on the flat-cull route, rebuilt each frame, at 1920x1080
     depth 9, 2 frames: set-up seconds, tlas_update_seconds per frame,
     frame ms; the path's kernels must launch and no other; then at
     animation frame 3 K4 and K5 against their plain versions and K1 on
     8,192 lanes of the refit pack's primary chunk and the sun shadow
     queue from them, K2 and K3 against theirs and K1 on
     262,144 lanes of the rebuilt pack's primaries and sorted bounce 1;
  5d. the V1 paths (RPTR_TRAVERSAL_V1=1, the v1 walk) at 1920x1080,
     1 spp, depth 9: cornell through K8a (its sample 0 bitwise the K1
     route's, both trees one node), cornell PT_WAVEFRONT through merged K8a
     launches only (sample 0 bitwise the V1 megakernel's),
     procedural.terrain(grid=40) (3,200 tris, a row-major table) through
     K8a, terrain200 and the village through K8b (field-major tables): the
     tree's nodes, leaves and padded rows, set-up seconds, timed frames as
     in 3; the path's kernel must launch and no other;
  6. K1 against its plain PyTorch version on the card: the cornell main
     path's shape (1080p chunk of 524,288 rays) and three terrain scenes
     (20k tris at leaf 32, 39k at 64, 80k at 128) with 262,144-ray coherent,
     incoherent and occlusion queues; rows and blocked flags must be equal,
     and t, u, v bitwise equal. On the terrain queues K2 and K3 too (the
     incoherent ones coherence-sorted, as the renderer sorts its bounce
     queues): each equal to its plain version and to K1, bitwise, and timed
     by its own raw launches (kernel-only) beside the wrapper's time; K2
     also in its merged mode, and against the reference's function (every
     survivor of a 128-lane group tested for every lane of it, the plain
     ``traverse_flat.plain_group``) with the lanes that differ counted and
     each shown to be grazing (the hit's leaf box fails the lane's own slab
     test), at leaf 32, 64 and 128;
  7. K2 and K3 at the terrain200 path's shapes: the 1080p frame's 2,097,152
     primary lanes (K2, unsorted) and a bounce-1 queue, the primaries' hit
     points with scattered directions, coherence-sorted (K3); closest and
     occluded, each equal to its plain version and to K1 bitwise, all three
     timed kernel-only with CUDA events beside the bound of the function; K2
     against the reference's function as in 6, and its merged mode (the
     bounce-1 queue, then the sun shadow queue) bitwise its plain version
     and its two single-mode launches, timed kernel-only and through the
     wrapper, its lanes against the reference's function counted; K3 (each
     lane's own leaves) also bitwise the reference's function, the plain
     version over groups of 128 lanes (here and in 6), with the pairs each
     tests: the group OR x 128 (the first K3's work), each lane's whole
     segment, and the bound's, up to K1's closest hit;
  8. K4 and K5 at the terrain500 1080p path's shapes: its primary chunk
     (524,288 lanes) with the most hits, a bounce-1 chunk (the primaries' hit points,
     scattered directions) and a sun shadow queue from those hit points.
     On each: K4 closest (coherence-sorted, as the renderer dispatches it)
     and any-hit, K5 closest (2 rounds) and any-hit (1 round), each with
     its K4 cleanup, against their plain versions (rows and flags equal,
     t/u/v bitwise), and one K5 launch of the first round against its plain
     version; across kernels K4 = K5 = K1 (K1 over a resident leaf-128 BVH
     of the same triangles): triangle ids equal except on exact-t ties,
     which are counted, and t bitwise equal everywhere. Timed with CUDA
     events beside the bound of the function. K4's ordered walk on the
     primary and bounce-1 chunks: bitwise its plain version, and equal to
     the sorted walk (t bitwise, ties counted);
  8b. on the quantized terrain500 pack (int16 tiles): K4 closest sorted,
     K4 ordered, K5 closest (2 rounds) and any-hit (1 round) and single K5
     launches, the multislot dispatch (timed against its one K5 launch),
     each bitwise its plain version; K4 = K5 = multislot except on exact-t
     ties;
  9. the goldens cornell_diffuse, sun_sky, cornell_textured,
     cornell_wavefront, cornell_sobol, cornell_zsbl and cornell_bn rendered
     on the card, through K1: against the port's
     own CPU render of them (the CPU tests hold that render to the JAX
     package run op by op) with equal ray counts, at most 1% of pixels over
     1e-3 (2% on cornell_textured, goldens.py says why) and a relative L1
     error of at most 1e-4 (goldens.compare_card), and against
     tests/goldens/*.pfm at the golden gate of goldens.py; the display
     images (readback_framebuffer) against the CPU's display images by
     goldens.compare_card;
 10. a small terrain (48x48, 8k tris) forced onto the flat-cull route
     (RPTR_TRAVERSAL_V3=1, the wavefront executor) on the card against the
     port's CPU render of it: equal ray counts and goldens.compare_card;
 11. procedural.terrain(grid=48), 4,608 tris in 5 subtrees, forced onto the
     streamed route (RPTR_FORCE_STREAMED_TRAVERSAL=1) at 48x48 on the card
     against the port's CPU render: equal ray counts and
     goldens.compare_card; K4 and K5 must launch; then switched to 16-bit
     quantized tiles by Renderer.configure_for (which must return True),
     the same;
 12. K6 and K7 at the instanced paths' shapes: on each path, the primary
     chunk with the most hits, a bounce-1 queue (the primaries' hit points,
     scattered directions) and the sun shadow queue from those hit points,
     closest and any-hit, each against its plain version (rows, instances,
     flags equal, t/u/v bitwise), timed with CUDA events beside the bound
     and its share of the bound, in the placement and block size the
     launcher picks; each also in both placements of the top tree (staged
     in shared memory, read from global memory) at 128, 256 and 512
     threads per block, each bitwise the plain version and timed (the
     measurement behind the launcher's rule);
     on the instanced500 queues K6 = K7 (a K7 pack of the same scene and
     frame): t bitwise, triangle and instance equal except on exact-t ties,
     which are counted, flags equal; K6's ordered instance walk on the
     instanced500 primary and bounce-1 queues: bitwise its plain version,
     and equal to the preorder walk except on exact-t ties (counted); on
     the instanced2500 primary chunk K7 with its top tree in global memory
     against K7 staged in shared memory and the plain version, bitwise,
     both timed, at each block size too;
 13. procedural.instanced_field(num_inst=6) at 48x48, depth 9, two animated
     frames, through K6 and through K7 (K6's instance cap set to 0), on the
     card against the port's CPU render: equal ray counts and
     goldens.compare_card; K6, then K7, must launch; then the same field with
     alpha-cut textures on its rock and tree materials (the alpha hops run on
     the two-level kernels, per-instance material offsets included);
 13b. procedural.instanced_field(num_inst=6) flattened at 48x48, depth 9,
     at animation frame 2: rebuilt on the K1 route, refit on the streamed
     and the flat-cull routes, on the card against the port's CPU render:
     equal rays and goldens.compare_card; the route's kernels launch;
 14. the merged two-queue modes on the card, one queue pair each: K1 on the
     cornell primary chunk and its NEE shadow queue (to points on the area
     light), K2 on the terrain200 bounce-1 queue (coherence-sorted) and the
     sun shadow queue of the primaries' hit points, K4 on the terrain500
     1080p bounce-1 chunk (sorted) and sun shadow queue of phase 8: each
     merged launch equal to its plain version (the plain closest walk on
     the first queue, the plain occluded walk on the second) and to the
     kernel's two separate launches, bitwise; timed with CUDA events beside
     the sum of the two halves' bounds and the two separate launches (K1
     and K2 also by their own launches, beside the wrapper's time).
 15. K8a and K8b on each V1 path's primary chunk with the most hits, a
     bounce-1 chunk (unsorted, as V1 dispatches it) and its sun shadow
     queue: closest, any-hit and merged, each bitwise its plain version (the
     per-lane walk) and the merged launch bitwise the two single-mode
     launches, timed by their own launches and through the wrapper with
     CUDA events beside the bound of each queue over the V1 tree's leaf
     boxes and the plain version; on every V1 path the kernel against K1's
     walk of the same leaf-128 tree (triangles and t on every lane of the
     primary and bounce-1 chunks, flags on the shadow queue: no lane may
     differ), and the lanes where it differs from the packet walk (the
     reference's function) counted, each shown to be grazing (its packet
     hit's leaf box, or an ancestor's, fails the lane's own slab test);
 16. Renderer.render_ray_queries, closest-hit and integrator modes, and
     render_aovs / readback_aov at 64x36 on the card against the port's
     CPU run: cornell (K1 and V1), terrain200 (K2 and V1), a 48x48-grid
     streamed terrain and a six-instance field; closest hits equal, the
     integrator queries at goldens.compare_card, each AOV buffer within
     1e-4 on at least 99% of its pixels (the camera rays differ in their
     last bits between the card and the CPU: torch divides a CUDA tensor
     by a scalar through its reciprocal, so a ray that grazes an edge can
     hit another triangle).
 17. binned RIS light selection (options.light_sampling_variant RIS, by
     configure_for) on the village path of 3b at 1920x1080, depth 9: timed
     frames, K2 and K3 and no other, NEE samples dropped per frame at most
     one per million rays (as on every timed path); its frame walls in
     turns with uniform selection's on the same renderer ((uniform, RIS,
     RIS, uniform) x 2, each after a warm-up frame), and 8,192 lanes of
     chunk 2's sample 0 traced on the card and on the port's CPU (the
     village on the K1 route) at goldens.compare_card with equal rays;
     then, uniform again, the debug images of options.debug_mode 1-3
     (render_debug_image) over the whole frame, with 4,096 lanes of the
     chunk equal to the CPU's counts and to the image, exactly;
 18. cornell at 1920x1080, depth 9, with thin-lens DoF (aperture 0.05,
     focus 3.2): timed frames, K1 and no other; its walls in turns with the
     pinhole main path's ((pinhole, DoF, DoF, pinhole) x 2); 16,384 lanes of
     chunk 2 against the CPU as in 17; the pinhole frame's ray-stats image
     (render_ray_stats) with those lanes equal to the CPU's counts; the
     RT_DEBUG and GBUFFER views at 1920x1080 and at 64x36 against the CPU's
     (within 1e-4 on 99% of the pixels);
 19. the axis-aligned queue of tests/test_torch_slab.py (x = 0 directions
     from leaf-box faces of a 1,058-triangle terrain's flat pack at leaf 32,
     64 and 128) through all nine kernels, closest and any-hit, each
     bitwise its plain version on the CPU, the lanes where it differs from
     a brute-force Moller-Trumbore over every triangle counted and printed;
 20. the image-domain frame path (phase_postprocess): cornell at 1920x1080,
     depth 9, under REPROJECTION_MODE_ACCUMULATE (window 8), TAA and an
     upscale of 2, 8 frames with a moving camera: frame ms, K1 and no
     other, the 3840x2160 display finite, resolved in [0, 1] and within
     TAA's variance clamp after TAA (its Lanczos history rings past 1,
     in the reference too), the renderer's
     timers window for RENDERING, PROCESSING, TAA and READBACK; the chain
     at 64x36 on the card against the CPU (goldens.compare_card); the raster
     G-buffer at 1920x1080 (ms) and at 64x36 against the CPU; an LoD scene
     whose camera crosses a selection change (one rebuild, K1, ray queries
     equal to the CPU's); a checkpoint round trip on the card (bitwise).
 21. the app shell (phase_app): ``python -m ...app.cli cornell --disable-ui
     --png`` as a process at 1920x1080; in process ``--disable-ui``,
     ``--validation`` (4 spp), ``--profiling`` (8 frames: the reference's
     CSV columns, a row per frame, each row's render time its own frame's
     CUDA-event time), ``--data-capture`` (2 spp, 2 viewpoints: every file
     the reference names, finite) and the interactive viewer (one /frame
     of 1920x1080, a key that moves the camera, /quit), K1 and no other in
     each; four fresh renderers' first frames without and with a joined
     ``warmup_async`` (walls, bitwise-equal images); ``--validation`` at
     64x36 on the card against ``--backend cpu`` (goldens.compare_card).
 22. multi-device rendering (phase_multi_device) on min(max(2, cards), 4)
     devices, distinct cards where there are that many, else cuda:0
     repeated (printed): cornell at 1920x1080 depth 9 (2 frames, 68 K1
     launches a frame), the village at 1920x1080 depth 9 through the
     monolith (the wavefront executor is off on several devices; the
     single renderer runs with RPTR_HOST_WAVEFRONT=0; K2, K3) and the
     instanced600 bench row (512x384, depth 3, 8 animated frames, K7), each
     on Renderer(devices=...) and on a single-device renderer in the same
     process: every frame bitwise, equal launches and rays, every replica's
     tensors and chunk c's accumulators on their device, each kernel's
     launches tallied by the device they ran on, the walls beside the
     single device's; build_sharded_render at 1920x1080 over two 540-row
     bands bitwise render_tile of the whole frame; dryrun_multichip(4); the
     CLI with --devices 1 at 1920x1080 and with one device more than the
     cards (the reference's error).
Every timed path also counts the fused shading kernels' launches and reads
the renderer's fused share of its last frame: either both kernels launch and
the share is 100%, or neither does and it is 0%; the village and terrain500
paths must read 100%, the instanced (two-level) paths 0%.
Every bound counts the rows of each pierced leaf up to its real-row count
(the rows past it repeat the leaf's last triangle; K4-K7 from their tiles'
bits), and logs the bound over the padded leaves beside it. Its last two
lines are the kernels' JSON record (K1, K2, K3, K8a and K8b with their
kernel-only ms and the wrapper's beside them, K1, K2, K4, K8a and K8b each
with a merged record, K2, K8a and K8b with their grazing lanes, K1-K5
and K7 with ``paths``: their launches on the paths of 3d, 3e, 5e, 17, 18,
20, 21 and 22, every kernel with ``axis_lanes_off_brute_force`` from 19;
shade_hit and shade_scatter with their launches on the village and
terrain500 1080p paths of 3b and 5 as ``paths``, their kernel-only, plain
and bound ms of 3f's village bounce 0 and ``carries`` with every row of 3f)
and the result JSON.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "realtimepathtracingresearchframework_tpu_torch"
REF = "realtimepathtracingresearchframework_tpu/ops"
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "traverse_resident": (f"{PKG}/csrc/traverse_resident.cu",
                          f"{REF}/traverse_pallas2.py:363"),
    "traverse_flat_cull": (f"{PKG}/csrc/traverse_flat_cull.cu",
                           f"{REF}/traverse_pallas3.py:137"),
    "traverse_precull": (f"{PKG}/csrc/traverse_precull.cu",
                         f"{REF}/traverse_pallas3.py:723"),
    "traverse_streamed": (f"{PKG}/csrc/traverse_streamed.cu",
                          f"{REF}/traverse_stream.py:493"),
    "traverse_binned": (f"{PKG}/csrc/traverse_binned.cu",
                        f"{REF}/traverse_binned.py:218"),
    "traverse_tlas": (f"{PKG}/csrc/traverse_tlas.cu",
                      f"{REF}/traverse_tlas.py:202"),
    "traverse_tlas_stream": (f"{PKG}/csrc/traverse_tlas_stream.cu",
                             f"{REF}/traverse_tlas_stream.py:276"),
    "traverse_v1": (f"{PKG}/csrc/traverse_v1.cu",
                    f"{REF}/traverse_pallas.py:433"),
    # the port's eager shading; the reference shades in XLA
    "shade": (f"{PKG}/csrc/shade.cu", None),
}
# the two records of traverse_v1.cu: K8a (row-major table) replaces
# traverse_pallas.py::_kernel (pallas_call at :433), K8b (field-major)
# ::_kernel_lane (pallas_call at :452)
V1_KERNELS = {"K8a": f"{REF}/traverse_pallas.py:433",
              "K8b": f"{REF}/traverse_pallas.py:452"}
# the two records of shade.cu, which replaces no TPU kernel
SHADE_KERNELS = ("shade_hit", "shade_scatter")
V1_PATHS = (  # label, frame_setup scene, grid, timed frames, kernel
    ("v1 cornell 1080p", "cornell", 200, 2, "K8a"),
    ("v1 terrain40 1080p", "terrain", 40, 2, "K8a"),
    ("v1 terrain200 1080p", "terrain", 200, 1, "K8b"),
    ("v1 village 1080p", "village", 200, 1, "K8b"),
)
QUERY_SIZE = (64, 36)  # the AOV passes of the query phase
N_QUERIES = 1024  # closest-hit queries per scene (128 through the integrator)
QUEUE = 262_144
TIMED_FRAMES = 4
STREAM_FRAMES = 3  # timed frames of the terrain500 1080p path
MAIN_SIZE = (1920, 1080)
# the share of a fused shading launch's lanes on which a field may differ
# from the plain version (PERF.md names each field that does)
SHADE_LANES_OFF = 0.0
BENCH_SIZE = (512, 384)  # bench.py's terrain row
STREAM_GRID = 500  # procedural.terrain(grid=500): 500,000 tris
TLAS_PATHS = (  # label, instances, size, depth, timed frames, kernel
    ("instanced600 bench row", 600, BENCH_SIZE, 3, 8, "K7"),
    ("instanced600 1080p", 600, MAIN_SIZE, 9, 3, "K7"),
    ("instanced500 1080p", 500, MAIN_SIZE, 9, 3, "K6"),
)
ANIM_FRAMES = 16  # instanced_field's animation length
INST_PAST_CAP = 2500  # instanced_field(num_inst=2500): 2,501 K7 entries
REF_MAX_ENTRIES = 2048  # the reference's K7 cap (traverse_tlas_stream.py:82)
TLAS_BLOCKS = (128, 256, 512)  # the block sizes phase 12 times for K6 and K7
DEVICE = "cuda"
# the bound of the traversal function (PERF.md): the larger of the bytes
# over the card's memory rate and the Moller-Trumbore flops over its f32
# rate (H100 SXM data sheet). 54 flops per ray and triangle, counted from
# traverse_pallas2._mt_leaf: 9 (p) + 5 (det) + 2 (|det| test) + 1 (1/det)
# + 3 (tvec) + 6 (u) + 9 (q) + 6 (v) + 6 (t) + 7 (the hit tests).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
MT_FLOPS = 54
RAY_BYTES = 32  # in: ro3, rd3, tmin, tmax
HIT_BYTES = 16  # out: t, row, u, v (1 for a blocked flag); K6 adds inst


T0 = time.perf_counter()


def log(*args):
    """Print a line, prefixed with the seconds since the script started."""
    print(f"[{time.perf_counter() - T0:7.1f} s]", *args, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, iters, warm=True):
    """Mean ms per call of fn() over ``iters`` calls, after one warm-up
    call unless ``warm`` is False, timed with CUDA events."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def env(**kv):
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_device():
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)  # as nvidia-smi gives it, on a line of its own
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    from realtimepathtracingresearchframework_tpu_torch.kernels import build

    t0 = time.perf_counter()
    paths = build.build_many(list(KERNELS), verbose=True)
    for name in KERNELS:
        build.load(name)
    secs = time.perf_counter() - t0
    log(f"build: {[os.path.relpath(p, REPO) for p in paths]} in {secs:.2f} s")
    return secs


def _soa(a, dev):
    import torch

    from realtimepathtracingresearchframework_tpu_torch.ops.vec3 import Vec3

    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    return Vec3(t[:, 0].contiguous(), t[:, 1].contiguous(), t[:, 2].contiguous())


def _bitwise(a, b):
    """(mismatches, max |a - b|) of two tensors, compared as bit patterns."""
    a, b = a.cpu().numpy(), b.cpu().numpy()
    if a.dtype == np.float32:
        diff = np.abs(a.astype(np.float64) - b)
        return int((a.view(np.int32) != b.view(np.int32)).sum()), float(
            diff.max(initial=0.0))
    return int((a != b).sum()), 0.0


def raw_ms(run, iters=50):
    """Kernel-only ms of one launch: CUDA events around ``iters`` raw
    launches (``run``, a wrapper module's ``bind``: operands and outputs
    built beforehand, no wrapper around the launch)."""
    def launch():
        rc = run()
        if rc != 0:
            raise RuntimeError(f"raw launch failed (cudaError {rc})")
    return cuda_ms(launch, iters)


def k1_kernel_ms(bvh, rays, shadow_from, iters=50):
    """K1's kernel-only ms on a packed (8, n) operand (``raw_ms``), in the
    leaf service and row-table placement the wrapper picks."""
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_resident as tr,
    )

    rays = rays.contiguous()
    return raw_ms(tr.bind(bvh, tuple(rays[0:6]), rays[6], rays[7],
                          shadow_from)[0], iters)


def compare_queue(label, bvh, ro, rd, tmax=None, iters=20):
    """K1 vs plain on one queue (numpy (n,3) origins/directions), both
    modes. Returns max_abs_err, the closest mode's record (kernel-only ms,
    the wrapper's ms, the plain version's ms) and the closest-hit t (numpy)
    for building occlusion queues."""
    import torch

    from realtimepathtracingresearchframework_tpu_torch.ops import traverse
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_resident as tr,
    )

    dev = torch.device(DEVICE)
    o, d = _soa(ro, dev), _soa(rd, dev)
    t_max = 2.0e32 if tmax is None else torch.from_numpy(tmax).to(dev)
    hk = tr.closest_hit_resident(bvh, o, d, 0.0, t_max)
    hp = traverse.closest_hit_threaded(bvh, o, d, 0.0, t_max)
    torch.cuda.synchronize()
    rows_k, rows_p = hk.tri.cpu().numpy(), hp.tri.cpu().numpy()
    row_mismatch = int((rows_k != rows_p).sum())
    same = rows_k == rows_p
    err = 0.0
    bit_mismatch = 0
    for a, b in ((hk.t, hp.t), (hk.u, hp.u), (hk.v, hp.v)):
        a, b = a.cpu().numpy()[same], b.cpu().numpy()[same]
        bit_mismatch += int((a.view(np.int32) != b.view(np.int32)).sum())
        err = max(err, float(np.abs(a - b).max(initial=0.0)))
    w_ms = cuda_ms(lambda: tr.closest_hit_resident(bvh, o, d, 0.0, t_max), iters)
    rays, _ = tr.pack_rays(o, d, 0.0, t_max)
    k_ms = k1_kernel_ms(bvh, rays, -(-rays.shape[1] // tr.BLOCK))
    p_ms = cuda_ms(lambda: traverse.closest_hit_threaded(bvh, o, d, 0.0, t_max), 3)
    hits = float((rows_k >= 0).mean())
    log(f"  {label:28s} closest: rows {row_mismatch} mismatched, t/u/v "
        f"{bit_mismatch} not bitwise, hit {hits:.3f}, kernel {k_ms:.4f} ms "
        f"(through the wrapper {w_ms:.4f} ms), plain {p_ms:.3f} ms")
    check(row_mismatch == 0 and bit_mismatch == 0,
          f"{label}: K1 closest disagrees with its plain version")
    return err, {"ms": k_ms, "wrapper_ms": w_ms, "plain_ms": p_ms}, hk.t.cpu().numpy()


def compare_occlusion(label, bvh, ro, rd, tmax, iters=20):
    import torch

    from realtimepathtracingresearchframework_tpu_torch.ops import traverse
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_resident as tr,
    )

    dev = torch.device(DEVICE)
    o, d = _soa(ro, dev), _soa(rd, dev)
    tm = torch.from_numpy(np.ascontiguousarray(tmax, np.float32)).to(dev)
    bk = tr.occluded_resident(bvh, o, d, 0.0, tm).cpu().numpy()
    bp = traverse.occluded_threaded(bvh, o, d, 0.0, tm).cpu().numpy()
    mismatch = int((bk != bp).sum())
    w_ms = cuda_ms(lambda: tr.occluded_resident(bvh, o, d, 0.0, tm), iters)
    k_ms = k1_kernel_ms(bvh, tr.pack_rays(o, d, 0.0, tm)[0], 0)
    p_ms = cuda_ms(lambda: traverse.occluded_threaded(bvh, o, d, 0.0, tm), 3)
    log(f"  {label:28s} occluded: {mismatch} flags mismatched, blocked "
        f"{bk.mean():.3f}, kernel {k_ms:.4f} ms (through the wrapper "
        f"{w_ms:.4f} ms), plain {p_ms:.3f} ms")
    check(mismatch == 0, f"{label}: K1 any-hit disagrees with its plain version")


def _occlusion_tmax(t, rng):
    """tmax = 0.999 t (unblocked) on half the hit lanes, 1.001 t (blocked)
    on the other half; misses get 1e30."""
    hit = t < 1e30
    scale = np.where(rng.uniform(size=t.shape) < 0.5, 0.999, 1.001)
    return np.where(hit, t * scale, 1e30).astype(np.float32)


def _terrain_queues(lo, hi, rng):
    side = int(np.sqrt(QUEUE))
    u = np.linspace(-1.0, 1.0, side, dtype=np.float32)
    uu, vv = np.meshgrid(u, u)
    d = np.stack([uu.ravel(), -0.45 + 0.25 * vv.ravel(),
                  -np.ones(side * side, np.float32)], axis=-1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    eye = np.array([0.0, hi[1] + 4.0, hi[2] + 6.0], np.float32)
    coherent = (np.broadcast_to(eye, d.shape).copy(), d.astype(np.float32))
    ro = rng.uniform(lo, hi, (QUEUE, 3)).astype(np.float32)
    ro[:, 1] = rng.uniform(hi[1], hi[1] + 2.0, QUEUE)
    rd = rng.normal(size=(QUEUE, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return coherent, (ro, rd)


# ---------------------------------------------------------------------------
# K1, K2 and K3 on one packed queue
# ---------------------------------------------------------------------------


def _k1(fb, rays, any_hit):
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_resident as tr,
    )
    from realtimepathtracingresearchframework_tpu_torch.ops.vec3 import Vec3

    fn = tr.occluded_resident if any_hit else tr.closest_hit_resident
    return fn(fb, Vec3(*rays[0:3]), Vec3(*rays[3:6]), rays[6], rays[7])


def bound(aabbs, leaf_size, rays, t_end, any_hit, real_rows=None):
    """Least time the card could take for this queue's traversal (ms), and
    what bounds it: the larger of the bytes (32 B in per ray, 16 B out, 1 B
    for a blocked flag) over the memory rate and of 54 flops times the rows
    of each (ray, leaf) pair whose box the ray's segment [tmin, min(tmax,
    t_end)] pierces (the plain feeder's exact test, on this queue's data)
    over the f32 rate: each leaf's real-row count ``real_rows`` (the rows
    past it repeat the leaf's last triangle, so the function needs none of
    them), else ``leaf_size``; with ``real_rows`` it also logs the bound
    over the padded leaves beside it. Returns (ms, bound_by, pairs)."""
    import torch

    from realtimepathtracingresearchframework_tpu_torch.ops import traverse_flat as tf

    seg = rays.clone()
    seg[7] = torch.minimum(rays[7], t_end)
    n, lpad = rays.shape[1], aabbs.shape[1]
    weight = torch.full((lpad,), leaf_size, dtype=torch.int64, device=rays.device)
    if real_rows is not None:
        weight[:real_rows.shape[0]] = real_rows
    step = max(1, (1 << 23) // lpad)
    pairs = rows = 0
    for s in range(0, n, step):
        hits = tf.ray_leaf_hits(seg[:, s:s + step], aabbs)
        pairs += int(hits.sum())
        rows += int((hits.sum(0) * weight).sum())
    bytes_ms = n * (RAY_BYTES + (1 if any_hit else HIT_BYTES)) / PEAK_BYTES_PER_S * 1e3
    ops_ms = MT_FLOPS * rows / PEAK_F32_FLOPS * 1e3
    if real_rows is not None:
        padded = MT_FLOPS * leaf_size * pairs / PEAK_F32_FLOPS * 1e3
        log(f"    bound over {pairs} ray-leaf pairs: {rows} real rows of "
            f"{leaf_size * pairs} padded, {max(bytes_ms, ops_ms):.4f} ms "
            f"(over padded leaves {max(bytes_ms, padded):.4f} ms)")
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), pairs


def k3_pairs(aabbs, rays, q):
    """(group-OR pairs x q, per-lane pairs) of K3 on a packed queue: the
    (lane, leaf) pairs the reference's function tests (every leaf any lane
    of a q-lane group enters, for every lane of the group: the first K3's
    work) and those each lane's own exact test of its whole segment
    enters."""
    from realtimepathtracingresearchframework_tpu_torch.ops import traverse_flat as tf

    n, lpad = rays.shape[1], aabbs.shape[1]
    step = max(q, (1 << 23) // lpad // q * q)
    group = lane = 0
    for s in range(0, n, step):
        hits = tf.ray_leaf_hits(rays[:, s:s + step], aabbs)
        lane += int(hits.sum())
        group += int(hits.reshape(-1, q, lpad).any(1).sum()) * q
    return group, lane


def flat_kernel_ms(name, fb, rays, q, n_closest, iters=20):
    """K2's or K3's kernel-only ms on a packed (8, n) operand (``raw_ms``),
    its lanes from ``n_closest`` on any-hit (K3: all or none)."""
    from realtimepathtracingresearchframework_tpu_torch.ops import traverse_flat as tf

    mode = n_closest // q if name == tf.K2 else int(n_closest == 0)
    return raw_ms(tf.bind(name, fb, rays.contiguous(), q, n_closest, mode)[0],
                  iters)


def k2_against_reference(label, fb, rays, q, out, any_hit):
    """The lanes where K2's result ``out`` and the reference's function
    (``traverse_flat.plain_group``: every survivor of the q-lane group
    tested for every lane) differ on one queue, counted, each checked to be
    grazing (``traverse_flat.grazing``). Returns the count."""
    import torch

    from realtimepathtracingresearchframework_tpu_torch.ops import traverse_flat as tf

    ref = tf.plain_group(fb, rays, q, any_hit)
    if any_hit:
        differ = out != ref
    else:
        differ = (_bits(out[0]) != _bits(ref[0])) | (out[1] != ref[1])
    lanes = torch.nonzero(differ).squeeze(1)
    graze = tf.grazing(fb, rays, lanes, q, ref, any_hit)
    log(f"    {label}: {lanes.numel()} lanes where K2 "
        f"{'any-hit' if any_hit else 'closest'} differs from the reference "
        f"function, {sum(graze)} of them grazing")
    check(all(graze), f"{label}: {graze.count(False)} lanes differ from the "
          "reference function and are not grazing")
    return lanes.numel()


def compare_flat_queue(label, fb, rays, kernels, rng, iters=3):
    """K1, K2 and K3 on one packed (8, n) queue, closest and occluded: each
    flat-cull kernel equal to its plain version and to K1, bitwise (rows,
    flags, t/u/v bit patterns), timed by its own raw launches (kernel-only)
    beside the wrapper's time; K2 also in its merged mode (the closest
    queue's first half, then the occlusion queue's second half) against
    its plain version, and against the reference's function with its
    differing lanes counted and checked to be grazing; K3 also equal to
    the reference's function, the group-of-q plain version (each leaf any
    lane of the group enters, for every lane), with the pairs each tests.
    Returns {kernel: record} with the closest mode's times, max error and
    bound, and K1's kernel-only time on the queue."""
    import torch

    from realtimepathtracingresearchframework_tpu_torch.ops import traverse_flat as tf

    n = rays.shape[1]
    h1 = _k1(fb, rays, False)
    k1_ms = k1_kernel_ms(fb, rays, -(-n // 128))
    b_ms, b_by, pairs = bound(fb.aabbs, fb.leaf_size, rays, h1.t, False,
                              fb.real_rows)
    # occlusion segments just short of (0.999 t) or past (1.001 t) each hit
    live = rays[7] > rays[6]
    scale = torch.from_numpy(np.where(
        rng.uniform(size=n) < 0.5, 0.999, 1.001).astype(np.float32)).to(rays.device)
    orays = rays.clone()
    orays[7] = torch.where(live, torch.where(h1.tri >= 0, h1.t * scale, 1e30),
                           rays[7])
    b1 = _k1(fb, orays, True)
    k1_occ_ms = k1_kernel_ms(fb, orays, 0)
    out = {}
    for name, q in kernels:
        hk = tf.launch(name, fb, rays, q, False)
        torch.cuda.synchronize()
        p_ms = cuda_ms(lambda: tf.plain(name, fb, rays, q, False), 1, warm=False)
        hp = tf.plain(name, fb, rays, q, False)
        err, bad_p, bad_1 = 0.0, 0, 0
        for a, p, k1 in zip(hk, hp, h1):
            m, e = _bitwise(a, p)
            bad_p += m
            err = max(err, e)
            bad_1 += _bitwise(a, k1)[0]
        w_ms = cuda_ms(lambda: tf.launch(name, fb, rays, q, False), iters)
        k_ms = flat_kernel_ms(name, fb, rays, q, n)
        bk = tf.launch(name, fb, orays, q, True)
        bp = tf.plain(name, fb, orays, q, True)
        occ_p, occ_1 = _bitwise(bk, bp)[0], _bitwise(bk, b1)[0]
        occ_ms = flat_kernel_ms(name, fb, orays, q, 0)
        short = "K2" if name == tf.K2 else "K3"
        extra = ""
        bad_g = 0
        rec = {}
        if name == tf.K2:
            graze = (k2_against_reference(f"{label} closest", fb, rays, q, hk, False)
                     + k2_against_reference(f"{label} occluded", fb, orays, q, bk,
                                            True))
            nc = n // 2 // q * q
            mixed = torch.cat([rays[:, :nc], orays[:, nc:]], dim=1).contiguous()
            mk = tf.merged_launch(fb, mixed, q, nc)
            mp = tf.merged_plain(fb, mixed, q, nc)
            bad_m = _equal((*mk[0], mk[1]), (*mp[0], mp[1]))[0]
            check(bad_m == 0, f"{label}: K2 merged disagrees with its plain version")
            extra = (f"; merged ({nc} closest lanes) bitwise its plain version; "
                     f"{graze} lanes differ from the reference function")
            rec["grazing_lanes"] = graze
        if name == tf.K3:
            # the reference's function: the q-lane groups' OR of the lanes'
            # exact tests, then the same flush
            hg, g_ms = _plain_ms(lambda: tf._flush(
                fb, rays, tf.precull_leaf_masks(rays, fb.aabbs, q), q, False))
            bg = tf._flush(fb, orays, tf.precull_leaf_masks(orays, fb.aabbs, q),
                           q, True)
            bad_g = _equal(hk, hg)[0] + _bitwise(bk, bg)[0]
            g_pairs, l_pairs = k3_pairs(fb.aabbs, rays, q)
            # the two ways of serving a leaf: the warp for each holder in
            # turn (scan_from 33), each holder alone (1)
            ways = {}
            for sf in (33, 1):
                bad_g += _equal(hk, tf.launch(name, fb, rays, q, False, sf))[0]
                ways[sf] = cuda_ms(
                    lambda: tf.launch(name, fb, rays, q, False, sf), iters)
            extra = (f"; {bad_g} vs the group-of-{q} plain version (plain "
                     f"{g_ms:.1f} ms) and the two ways of serving a leaf not "
                     f"bitwise; warp-served {ways[33]:.3f} ms, holder scans "
                     f"{ways[1]:.3f} ms (default scan_from={tf.SCAN_FROM}); "
                     f"pairs: group OR x q {g_pairs}, per lane {l_pairs}, up "
                     f"to K1's hit {pairs}")
        log(f"  {label:26s} {short} (q={q}): closest {bad_p} vs plain, {bad_1} "
            f"vs K1 not bitwise, kernel {k_ms:.4f} ms (through the wrapper "
            f"{w_ms:.4f}; plain {p_ms:.1f}, K1 {k1_ms:.4f}); occluded {occ_p} vs "
            f"plain, {occ_1} vs K1 mismatched, blocked "
            f"{bk.float().mean().item():.3f}, kernel {occ_ms:.4f} ms (K1 "
            f"{k1_occ_ms:.4f}); hit {(h1.tri >= 0).float().mean().item():.3f}, "
            f"bound {b_ms:.4f} ms by {b_by} ({pairs} ray-leaf pairs){extra}")
        check(bad_p == 0 and occ_p == 0,
              f"{label}: {short} disagrees with its plain version")
        check(bad_1 == 0 and occ_1 == 0, f"{label}: {short} disagrees with K1")
        check(bad_g == 0, f"{label}: K3 disagrees with the group-of-{q} plain "
              "version or across its ways of serving a leaf")
        out[name] = dict(rec, ms=k_ms, wrapper_ms=w_ms, plain_ms=p_ms,
                         k1_ms=k1_ms, occ_ms=occ_ms, k1_occ_ms=k1_occ_ms,
                         max_abs_err=err, bound_ms=b_ms, bound_by=b_by)
    return out


def compare_merged(label, launch, plain, separate, rays, n_closest, b_ms,
                   iters=5):
    """One merged two-queue launch over the packed operand ``rays`` (its
    first ``n_closest`` lanes the closest queue) against its plain version
    and the kernel's two separate launches (``separate()``), bitwise, and
    timed with CUDA events. ``b_ms`` is the sum of the two halves' bounds.
    Returns the merged record."""
    import torch

    mk = launch(rays, n_closest)
    torch.cuda.synchronize()
    mp, p_ms = _plain_ms(lambda: plain(rays, n_closest))
    ms_ = separate()
    bad_p, err = _equal((*mk[0], mk[1]), (*mp[0], mp[1]))
    bad_s = _equal((*mk[0], mk[1]), (*ms_[0], ms_[1]))[0]
    k_ms = cuda_ms(lambda: launch(rays, n_closest), iters)
    sep_ms = cuda_ms(separate, iters)
    live_c = int((rays[7, :n_closest] > rays[6, :n_closest]).sum())
    live_s = int((rays[7, n_closest:] > rays[6, n_closest:]).sum())
    log(f"  {label}: merged launch of {n_closest} closest ({live_c} live) + "
        f"{rays.shape[1] - n_closest} shadow lanes ({live_s} live): {bad_p} vs "
        f"plain, {bad_s} vs the two separate launches not bitwise; hit "
        f"{(mk[0][1] >= 0).float().mean().item():.3f}, blocked "
        f"{mk[1].float().mean().item():.3f}; {k_ms:.3f} ms (separate "
        f"{sep_ms:.3f} ms, plain {p_ms:.1f} ms), bound {b_ms:.4f} ms")
    check(bad_p == 0, f"{label}: merged launch disagrees with its plain version")
    check(bad_s == 0, f"{label}: merged launch disagrees with separate launches")
    return {"ms": k_ms, "plain_ms": p_ms, "separate_ms": sep_ms,
            "max_abs_err": err, "bound_ms": b_ms}


def merged_k1(bvh, ro, rd, t, lights, rng):
    """K1's merged mode on the cornell primary chunk (numpy ``ro``, ``rd``,
    closest ``t``) and its NEE shadow queue: from each primary hit point to
    a uniform point on a random triangle of the area light."""
    import torch

    from realtimepathtracingresearchframework_tpu_torch.ops import integrator
    from realtimepathtracingresearchframework_tpu_torch.ops import traverse_flat as tf
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_resident as tr,
    )

    n = ro.shape[0]
    lv = [torch.stack(list(getattr(lights, k)), -1).cpu().numpy().astype(np.float64)
          for k in ("v0", "v1", "v2")]
    li = rng.integers(0, lv[0].shape[0], n)
    su = np.sqrt(rng.uniform(size=n))[:, None]
    u2 = rng.uniform(size=n)[:, None]
    q = lv[0][li] * (1 - su) + lv[1][li] * (su * (1 - u2)) + lv[2][li] * (su * u2)
    hit = t < 1e30
    p = (ro + rd * np.where(hit, t, 0.0)[:, None]).astype(np.float32)
    d = q - p
    dist = np.linalg.norm(d, axis=-1)
    d = (d / np.maximum(dist, 1e-12)[:, None]).astype(np.float32)
    eps = ((np.linalg.norm(p, axis=-1) + np.where(hit, t, 0.0))
           * integrator.RAY_EPSILON).astype(np.float32)
    tmax = np.where(hit, dist - eps, 0.0).astype(np.float32)
    dev = torch.device(DEVICE)
    prim, _ = tr.pack_rays(_soa(ro, dev), _soa(rd, dev), 0.0, 2.0e32, tr.BLOCK)
    shadow, _ = tr.pack_rays(_soa(p, dev), _soa(d, dev),
                             torch.from_numpy(eps).to(dev),
                             torch.from_numpy(tmax).to(dev), tr.BLOCK)
    nc = prim.shape[1]
    rays = torch.cat([prim, shadow], dim=1).contiguous()
    c, sh = rays[:, :nc].contiguous(), rays[:, nc:].contiguous()

    def separate():
        # the two single-mode launches on the same packed halves, through
        # the launch the merged one takes (no wrapper around either)
        h = tr._launch(bvh, tuple(c[0:6]), c[6], c[7], nc // tr.BLOCK)[0]
        b = tr._launch(bvh, tuple(sh[0:6]), sh[6], sh[7], 0)[1]
        return h, b

    aabbs = torch.from_numpy(tf.leaf_aabbs_for(
        bvh.tri_rows.cpu().numpy(), bvh.leaf_size)).to(dev)
    t_dev = torch.from_numpy(np.ascontiguousarray(t, np.float32)).to(dev)
    b_ms = (bound(aabbs, bvh.leaf_size, c, t_dev, False, bvh.real_rows)[0]
            + bound(aabbs, bvh.leaf_size, sh, sh[7], True, bvh.real_rows)[0])
    rec = compare_merged(
        "K1 cornell primary chunk + NEE shadow queue",
        lambda x, k: tr.merged_launch(bvh, x, k),
        lambda x, k: tr.merged_plain(bvh, x, k), separate, rays, nc, b_ms)
    k_ms = k1_kernel_ms(bvh, rays, nc // tr.BLOCK)
    sep_ms = (k1_kernel_ms(bvh, c, nc // tr.BLOCK) + k1_kernel_ms(bvh, sh, 0))
    log(f"  K1 merged: kernel {k_ms:.4f} ms (through the wrapper "
        f"{rec['ms']:.4f} ms), the two single-mode kernels {sep_ms:.4f} ms")
    return dict(rec, ms=k_ms, wrapper_ms=rec["ms"], separate_kernel_ms=sep_ms)


def phase_parity(smi):
    """K1 vs plain at the main path's shape and on the terrain queues, and
    K2/K3 on the terrain queues; K1's merged mode on the cornell primary
    chunk and its NEE shadow queue. Returns K1's record at the main path's
    shape."""
    import torch

    from realtimepathtracingresearchframework_tpu_torch.backend.renderer import (
        Renderer,
        resident_leaf_size,
    )
    from realtimepathtracingresearchframework_tpu_torch.models import procedural
    from realtimepathtracingresearchframework_tpu_torch.models.camera import (
        OrientedCamera,
    )
    from realtimepathtracingresearchframework_tpu_torch.models.scene import Scene
    from realtimepathtracingresearchframework_tpu_torch.ops import bvh as bvh_mod
    from realtimepathtracingresearchframework_tpu_torch.ops import integrator
    from realtimepathtracingresearchframework_tpu_torch.ops import pointsets
    from realtimepathtracingresearchframework_tpu_torch.ops import traverse_flat as tf
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_resident as tr,
    )

    rng = np.random.default_rng(20261016)
    # the main path's shape: primary rays of its first chunk on cornell
    width, height = MAIN_SIZE
    r = Renderer(device=DEVICE)
    r.set_scene(Scene.from_vkr_scene(procedural.cornell_box()))
    cam = OrientedCamera.look_at([0, 1.0, 3.2], [0, 1.0, 0.0], fovy=50)
    view = integrator.ViewBuffers(*(
        torch.from_numpy(a).to(DEVICE) for a in cam.view_basis(width, height)
    ))
    px, py, _valid, _lin, _inv, _nc, chunk = integrator.swizzle_host(width, height)
    px = torch.from_numpy(px[:chunk]).to(DEVICE)
    py = torch.from_numpy(py[:chunk]).to(DEVICE)
    state = pointsets.make_state(0, 0, 0, px, py, width)
    _, ro, rd = integrator.camera_setup(
        integrator.IntegratorConfig(), view, px, py,
        (float(width), float(height)), state,
    )
    ro = torch.stack(list(ro), -1).cpu().numpy()
    rd = torch.stack(list(rd), -1).cpu().numpy()
    bvh = r.device_scene.bvh
    log(f"K1 vs plain, cornell ({bvh.tri_rows.shape[0]} rows, leaf "
        f"{bvh.leaf_size}, {bvh.num_nodes} nodes), {ro.shape[0]} rays:")
    err, rec, t = compare_queue("cornell primary", bvh, ro, rd)
    # K1's bound at the main path's shape: the flat cull's leaf boxes of
    # cornell measure the pierced leaves
    aabbs = torch.from_numpy(tf.leaf_aabbs_for(
        bvh.tri_rows.cpu().numpy(), bvh.leaf_size)).to(DEVICE)
    rays, _ = tr.pack_rays(_soa(ro, DEVICE), _soa(rd, DEVICE), 0.0, 2.0e32)
    b_ms, b_by, _pairs = bound(aabbs, bvh.leaf_size, rays,
                               torch.from_numpy(t).to(DEVICE), False,
                               bvh.real_rows)
    k1 = dict(rec, max_abs_err=err, bound_ms=b_ms, bound_by=b_by)
    log(f"K1 merged mode, {smi}:")
    k1["merged"] = merged_k1(bvh, ro, rd, t, r.device_scene.lights, rng)
    hit = t < 1e30
    p = ro + rd * np.where(hit, t, 0.0)[:, None]
    d2 = rng.normal(size=rd.shape).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    compare_occlusion("cornell bounce (occlusion)", bvh, p, d2,
                      np.full(len(p), 1e30, np.float32))
    compare_occlusion("cornell primary (occlusion)", bvh, ro, rd,
                      _occlusion_tmax(t, rng))

    for grid in (100, 140, 200):
        flat = Scene.from_vkr_scene(procedural.terrain(grid=grid)).flatten_world()
        ls = resident_leaf_size(flat.num_tris)
        tb = bvh_mod.thread_bvh(
            bvh_mod.build_bvh_sah(flat.v0, flat.e1, flat.e2, leaf_size=ls),
            flat.v0, flat.e1, flat.e2,
        )
        fb = tf.pack_flat(tb, DEVICE)
        log(f"K1 vs plain, terrain grid={grid} ({flat.num_tris} tris, leaf "
            f"{ls}, {fb.num_nodes} nodes, {fb.num_leaves} leaves), {QUEUE} rays:")
        lo, hi = flat.v0.min(0), flat.v0.max(0)
        coherent, incoherent = _terrain_queues(lo, hi, rng)
        for name, (qo, qd) in (("coherent", coherent), ("incoherent", incoherent)):
            e, _, t = compare_queue(f"terrain{grid} {name}", fb, qo, qd)
            err = max(err, e)
            compare_occlusion(f"terrain{grid} {name}", fb, qo, qd,
                              _occlusion_tmax(t, rng))
            # K2 and K3 on the same queue: primaries-like coherent rays
            # unsorted, incoherent ones coherence-sorted
            rays, _ = tr.pack_rays(_soa(qo, DEVICE), _soa(qd, DEVICE), 0.0,
                                   2.0e32, 1024)
            if name == "incoherent":
                rays, _ = tr._compact(rays, fb.scene_lo, fb.scene_hi)
            compare_flat_queue(f"terrain{grid} {name}", fb, rays,
                               ((tf.K2, 128), (tf.K3, 128)), rng)
    return k1


def flat_queues(r, cfg, rng):
    """(primaries, bounce 1, sun shadow) packed queues of a 1080p flat-cull
    path ``r``: the frame's primaries (dead on invalid pixels); the
    primaries' hit points with scattered directions, dead where the primary
    missed, coherence-sorted like the renderer's bounce queues; the sun
    shadow queue from the same points (unsorted, as bounce 0's is)."""
    import torch

    from realtimepathtracingresearchframework_tpu_torch.ops import integrator
    from realtimepathtracingresearchframework_tpu_torch.ops import pointsets
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_resident as tr,
    )
    from realtimepathtracingresearchframework_tpu_torch.ops.intersect import T_MAX
    from realtimepathtracingresearchframework_tpu_torch.ops.vec3 import Vec3

    width, height = r.fb_width, r.fb_height
    fb = r.device_scene.bvh
    px, py, valid = (torch.cat(c) for c in r._swizzle)
    view = integrator.ViewBuffers(*(
        torch.from_numpy(a).to(DEVICE)
        for a in cfg.camera.view_basis(width, height)
    ))
    state = pointsets.make_state(0, 0, 0, px, py, width)
    _, ro, rd = integrator.camera_setup(
        integrator.IntegratorConfig(), view, px, py,
        (float(width), float(height)), state,
    )
    prim, _ = tr.pack_rays(ro, rd, 0.0, torch.where(valid, T_MAX, 0.0), 512)
    h = _k1(fb, prim, False)
    hit = h.tri >= 0
    p = [prim[k] + prim[3 + k] * torch.where(hit, h.t, 0.0) for k in range(3)]
    d = torch.from_numpy(rng.normal(size=(3, prim.shape[1])).astype(np.float32)
                         ).to(DEVICE)
    d = d / torch.sqrt((d * d).sum(0))
    tmin = (torch.sqrt(p[0] * p[0] + p[1] * p[1] + p[2] * p[2])
            + torch.where(hit, h.t, 0.0)) * integrator.RAY_EPSILON
    bounce, _ = tr.pack_rays(Vec3(*p), Vec3(*d), tmin,
                             torch.where(hit, T_MAX, 0.0), 1024)
    bounce, _ = tr._compact(bounce, fb.scene_lo, fb.scene_hi)
    sun = np.asarray(cfg.scene_config.sun_dir, np.float32)
    sun = torch.from_numpy(sun / np.linalg.norm(sun)).to(DEVICE)
    n = prim.shape[1]
    shadow, _ = tr.pack_rays(Vec3(*p), Vec3(*(sun[k].expand(n) for k in range(3))),
                             tmin, torch.where(hit, 2.0e16, 0.0), 512)
    return prim, bounce, shadow


def phase_flat(smi):
    """K2 and K3 at the terrain200 path's shapes against their plain
    versions and K1. Returns {kernel: record}."""
    import torch

    from realtimepathtracingresearchframework_tpu_torch.ops import traverse_flat as tf
    from realtimepathtracingresearchframework_tpu_torch.profile_frame import (
        frame_setup,
    )

    rng = np.random.default_rng(7)
    r, cfg = frame_setup("terrain", DEVICE, MAIN_SIZE)
    fb = r.device_scene.bvh
    check(isinstance(fb, tf.FlatBVH), "terrain200 is not on the flat-cull route")
    prim, bounce, shadow = flat_queues(r, cfg, rng)
    log(f"K1, K2, K3 at the terrain200 path's shapes ({fb.num_leaves} leaves "
        f"of {fb.leaf_size}), {smi}:")
    rec = compare_flat_queue("frame primaries", fb, prim, ((tf.K2, 128),), rng)
    live = int((bounce[7] > bounce[6]).sum())
    rec.update(compare_flat_queue(
        f"bounce 1 sorted ({live} live)", fb, bounce, ((tf.K3, 128),), rng))
    # K2's merged mode: the sorted bounce-1 queue, then the sun shadow queue
    nc = bounce.shape[1]
    rays = torch.cat([bounce, shadow], dim=1).contiguous()
    t_b = tf.launch(tf.K2, fb, bounce, 128, False)[0]
    b_ms = (bound(fb.aabbs, fb.leaf_size, bounce, t_b, False, fb.real_rows)[0]
            + bound(fb.aabbs, fb.leaf_size, shadow, shadow[7], True, fb.real_rows)[0])
    log(f"K2 merged mode, {smi}:")
    merged = compare_merged(
        "K2 terrain200 bounce 1 sorted + sun shadow queue",
        lambda x, k: tf.merged_launch(fb, x, 128, k),
        lambda x, k: tf.merged_plain(fb, x, 128, k),
        lambda: (tf.launch(tf.K2, fb, bounce, 128, False),
                 tf.launch(tf.K2, fb, shadow, 128, True)),
        rays, nc, b_ms)
    mk = tf.merged_launch(fb, rays, 128, nc)
    graze = (k2_against_reference("merged closest half", fb, bounce, 128, mk[0],
                                  False)
             + k2_against_reference("merged shadow half", fb, shadow, 128, mk[1],
                                    True))
    k_ms = flat_kernel_ms(tf.K2, fb, rays, 128, nc)
    sep_ms = (flat_kernel_ms(tf.K2, fb, bounce, 128, nc)
              + flat_kernel_ms(tf.K2, fb, shadow, 128, 0))
    log(f"  K2 merged: kernel {k_ms:.4f} ms (through the wrapper "
        f"{merged['ms']:.4f} ms), the two single-mode kernels {sep_ms:.4f} ms; "
        f"{graze} lanes differ from the reference function")
    rec[tf.K2]["merged"] = dict(merged, ms=k_ms, wrapper_ms=merged["ms"],
                                separate_kernel_ms=sep_ms)
    rec[tf.K2]["grazing_lanes"] += graze
    return rec


def phase_goldens():
    from realtimepathtracingresearchframework_tpu_torch import goldens
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_resident as tr,
    )

    for name in goldens.ALL_NAMES:
        before = tr.launches
        img, r = goldens.render(name, DEVICE)
        launched = tr.launches - before
        cpu_img, cpu_r = goldens.render(name, "cpu")
        rays, cpu_rays = r.last_frame_rays(), cpu_r.last_frame_rays()
        vs_cpu = goldens.compare_card(img, cpu_img)
        vs_golden = goldens.compare(name, img)
        disp = goldens.compare_card(r.readback_framebuffer()[..., :3],
                                    cpu_r.readback_framebuffer()[..., :3])
        log(f"golden {name}: vs port CPU render {vs_cpu}; vs golden "
            f"{vs_golden}; display image vs the CPU's {disp}; rays {rays} "
            f"(CPU {cpu_rays}), K1 launches {launched}")
        check(rays == cpu_rays, f"golden {name}: {rays} rays, CPU {cpu_rays}")
        check(vs_cpu["ok"], f"golden {name}: card render off the CPU render: {vs_cpu}")
        check(disp["ok"], f"golden {name}: display image off the CPU's: {disp}")
        check(vs_golden["ok"], f"golden {name} outside tolerance: {vs_golden}")
        check(launched > 0, f"golden {name} did not launch K1")


def phase_small_terrain():
    """A small terrain forced onto the flat-cull route, on the card against
    the port's CPU render."""
    from realtimepathtracingresearchframework_tpu_torch import goldens
    from realtimepathtracingresearchframework_tpu_torch.ops import traverse_flat as tf
    from realtimepathtracingresearchframework_tpu_torch.profile_frame import (
        frame_setup,
    )

    out = {}
    with env(RPTR_TRAVERSAL_V3="1"):
        for device in (DEVICE, "cpu"):
            before = (tf.launches_k2, tf.launches_k3)
            r, cfg = frame_setup("terrain", device, (48, 48), grid=64)
            rays = []
            for _ in range(2):
                r.render(cfg)
                rays.append(r.last_frame_rays())
            out[device] = (r.readback_accumulation()[..., :3], rays,
                           (tf.launches_k2 - before[0], tf.launches_k3 - before[1]))
    (img, rays, launched), (cpu_img, cpu_rays, _) = out[DEVICE], out["cpu"]
    vs_cpu = goldens.compare_card(img, cpu_img)
    log(f"terrain grid=64 48x48 depth 9, 2 frames, flat-cull route: vs port "
        f"CPU render {vs_cpu}; rays {rays} (CPU {cpu_rays}), K2/K3 launches "
        f"{launched}")
    check(rays == cpu_rays, f"small terrain: rays {rays}, CPU {cpu_rays}")
    check(vs_cpu["ok"], f"small terrain: card render off the CPU render: {vs_cpu}")
    check(min(launched) > 0, "small terrain did not launch K2 and K3")


def _counters():
    """name -> (reset, read) of every traversal kernel's launch count."""
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_binned as tb,
    )
    from realtimepathtracingresearchframework_tpu_torch.ops import traverse_flat as tf
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_resident as tr,
    )
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_stream as ts,
    )
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_tlas as tt,
    )
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_tlas_stream as tts,
    )
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_v1 as tv,
    )

    return {
        "K1": (tr.reset_launches, lambda: tr.launches),
        "K2": (tf.reset_launches, lambda: tf.launches_k2),
        "K3": (lambda: None, lambda: tf.launches_k3),
        "K4": (ts.reset_launches, lambda: ts.launches_k4),
        "K5": (tb.reset_launches, lambda: tb.launches_k5),
        "K6": (tt.reset_launches, lambda: tt.launches_k6),
        "K7": (tts.reset_launches, lambda: tts.launches_k7),
        "K8a": (tv.reset_launches, lambda: tv.launches_k8a),
        "K8b": (lambda: None, lambda: tv.launches_k8b),
    }


def _mode_counts():
    """Launches of the kernel modes of this slice since the last reset: K4's
    ordered walk, K6's ordered instance walk, K7's global-memory top tree,
    the multislot dispatches (one K5 launch and one K4 cleanup each)."""
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_binned as tb,
    )
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_stream as ts,
    )
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_tlas as tt,
    )
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_tlas_stream as tts,
    )

    return {"K4 ordered": ts.launches_k4_ordered,
            "K6 ordered": tt.launches_k6_ordered,
            "K6 global": tt.launches_k6_global,
            "K7 global": tts.launches_k7_global,
            "multislot": tb.multislot_dispatches}


def _merged_counts():
    """Merged two-queue launches of K1, K2, K4 and K8 since their last
    reset."""
    from realtimepathtracingresearchframework_tpu_torch.ops import traverse_flat as tf
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_resident as tr,
    )
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_stream as ts,
    )
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_v1 as tv,
    )

    return {"K1": tr.merged_launches, "K2": tf.merged_launches_k2,
            "K4": ts.merged_launches_k4, "K8": tv.merged_launches}


def _only(label, launches, kernels):
    """The path launched every kernel of ``kernels`` and no other."""
    check(all(launches[k] > 0 for k in kernels),
          f"{label} did not launch {kernels}: {launches}")
    others = {k: n for k, n in launches.items() if k not in kernels and n}
    check(not others, f"{label} launched other kernels: {others}")


def _timed_frames(label, r, cfg, frames=TIMED_FRAMES, animate=False):
    """Warm-up plus ``frames`` frames; with ``animate`` a TLAS update
    (``set_animation_frame``) before each, frame (f + 1) % 16 before timed
    frame f as bench.py's instanced row does, frame 0 before the warm-up.
    Returns the launch counts of the run, every count set to 0 just before
    it and read just after, and its record: median frame ms (CUDA events
    around ``render``), Mray/s, the TLAS updates' host ms (build, pack and
    upload, synchronised) and the frames' host ms with their update."""
    import dataclasses

    import torch

    from realtimepathtracingresearchframework_tpu_torch.backend.params import (
        TONEMAP_MODE_FAST,
    )
    from realtimepathtracingresearchframework_tpu_torch.ops import integrator
    from realtimepathtracingresearchframework_tpu_torch.ops import shade
    from realtimepathtracingresearchframework_tpu_torch.utils import profiling

    # the display image's tone map (Reinhard) keeps it in [0, 1]; it only
    # changes the resolve at readback, not the rendered samples
    cfg = dataclasses.replace(cfg, params=cfg.params.replace(
        early_tone_mapping_mode=TONEMAP_MODE_FAST))
    counters = _counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for reset, _ in counters.values():
        reset()
    integrator.reset_alpha_counts()
    integrator.reset_nee_dropped()
    profiling.reset_host_syncs()
    shade.reset_launches()
    t0 = time.perf_counter()
    if animate:
        r.set_animation_frame(0)
    r.render(cfg)  # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    frame_ms, update_ms, total_ms, rays, marker_ms = [], [], [], [], []
    for f in range(frames):
        t0 = time.perf_counter()
        if animate:
            r.set_animation_frame((f + 1) % ANIM_FRAMES)
            torch.cuda.synchronize()
            marker_ms.append(r.tlas_update_seconds * 1e3)
        t1 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        r.render(cfg)
        end.record()
        torch.cuda.synchronize()
        total_ms.append((time.perf_counter() - t0) * 1e3)
        update_ms.append((t1 - t0) * 1e3)
        frame_ms.append(start.elapsed_time(end))
        rays.append(r.last_frame_rays())
    launches = {k: read() for k, (_, read) in counters.items()}
    shaded = dict(shade.launches)
    share = r.shade_fused_share
    modes = _mode_counts()
    merged = _merged_counts()
    alpha = {"hops": integrator.alpha_hops / (frames + 1),
             "reads": profiling.host_syncs["alpha_cut"] / (frames + 1)}
    dropped = integrator.nee_dropped() / (frames + 1)
    peak = torch.cuda.max_memory_allocated()
    stats = r.stats()
    img = r.readback_accumulation()
    disp = r.readback_framebuffer()
    disp_ok = bool(np.isfinite(disp).all() and (disp >= 0).all()
                   and (disp <= 1).all())
    finite = bool(np.isfinite(img).all())
    nonneg = bool((img >= 0).all())
    mrays = sum(rays) / (sum(frame_ms) * 1e-3) / 1e6
    width, height = r.fb_width, r.fb_height
    anim = ""
    if animate:
        anim = (f"TLAS update ms {[round(x, 3) for x in update_ms]} (median "
                f"{float(np.median(update_ms)):.3f}; tlas_update_seconds ms "
                f"{[round(x, 3) for x in marker_ms]}"
                f"{', ' + r.animation_update if r.animation_update else ''}), "
                f"frame with update ms "
                f"median {float(np.median(total_ms)):.3f} "
                f"({sum(rays) / (sum(total_ms) * 1e-3) / 1e6:.3f} Mray/s), ")
    log(f"{label} {width}x{height} spp 1 depth "
        f"{cfg.params.max_path_depth}: warm-up "
        f"{warm_s * 1e3:.1f} ms, frame ms {[round(x, 3) for x in frame_ms]}, "
        f"median {float(np.median(frame_ms)):.3f} ms, {mrays:.3f} Mray/s "
        f"({rays[0]} rays/frame), last frame {frame_ms[-1]:.3f} ms by the "
        f"script's CUDA events, {stats.render_time:.3f} ms by "
        f"Renderer.stats().render_time, {anim}launches {launches} ("
        f"{frames + 1} frames), of them merged {merged}, modes {modes}, "
        f"fused shading launches {shaded} (last frame's fused share "
        f"{share}%), alpha test per frame "
        f"{alpha}, NEE samples dropped as non-finite per frame {dropped}, "
        f"live lanes per bounce "
        f"{r.live_profile}, peak memory {peak / 2**20:.1f} MiB, image finite "
        f"{finite} non-negative {nonneg} mean {float(img[..., :3].mean()):.5f}, "
        f"display image (readback_framebuffer) finite and in [0, 1] {disp_ok}, "
        f"mean {float(disp[..., :3].mean()):.5f}")
    check(finite and nonneg, f"{label} image is not finite and non-negative")
    check(disp_ok and disp.shape == (height, width, 4),
          f"{label}: display image not finite and in [0, 1], shape {disp.shape}")
    # the integrator drops a NEE sample whose contribution overflows (a light
    # sampled from a point in its own plane); more than one per million rays
    # would be a fault of another cause
    check(dropped <= 1e-6 * rays[0], f"{label}: {dropped} NEE samples per "
          f"frame dropped as non-finite, of {rays[0]} rays")
    check(img.shape == (height, width, 4), f"{label} image shape {img.shape}")
    # the route the renderer took is the one the kernels ran: every frame
    # through both fused kernels, or none through either
    check((share, all(shaded.values())) in ((100.0, True), (0.0, False))
          and any(shaded.values()) == all(shaded.values()),
          f"{label}: fused shading share {share}%, launches {shaded}")
    rec = {"frame_ms": float(np.median(frame_ms)), "mrays": mrays,
           "update_ms": float(np.median(update_ms)), "marker_ms": marker_ms,
           "total_ms": float(np.median(total_ms)),
           "per_frame": {k: n / (frames + 1) for k, n in launches.items()},
           "merged": merged, "modes": modes, "alpha": alpha,
           "nee_dropped": dropped, "rays": rays[0], "shade": shaded,
           "shade_fused_share": share}
    return launches, rec


def phase_main_path():
    """Cornell at MAIN_SIZE (1920x1080), 1 spp, depth 9, through the port's
    Renderer. Returns the K1 launch count of this run, the renderer and its
    FrameConfig."""
    from realtimepathtracingresearchframework_tpu_torch.profile_frame import (
        frame_setup,
    )

    r, cfg = frame_setup("cornell", DEVICE, MAIN_SIZE)
    launches, _ = _timed_frames("main path cornell", r, cfg)
    _only("main path", launches, ("K1",))
    return launches["K1"], r, cfg


def phase_village_path():
    """procedural.village() at MAIN_SIZE, 1 spp, depth 9, with bench.py's
    village camera, sun and sky, through the wavefront executor; then the
    mip levels against the CPU and this slice's village phases
    (``phase_village_b3``). Returns the launch counts of this run, of the
    RIS path and of the fused shading kernels in this run."""
    from realtimepathtracingresearchframework_tpu_torch.profile_frame import (
        frame_setup,
    )

    t0 = time.perf_counter()
    r, cfg = frame_setup("village", DEVICE, MAIN_SIZE)
    total = time.perf_counter() - t0
    atlas = r.device_scene.atlas
    check(r._has_textures and r._route.kernel_v3,
          f"village: textures {r._has_textures}, route {r._route}")
    log(f"village: {r.scene.total_tris} tris, {atlas.count} textures "
        f"({atlas.texels.shape[0]} texels), alpha test {r._has_alpha}; set-up "
        f"(BVH build, pack and upload) {r.setup_seconds:.2f} s, set_scene with "
        f"flatten and atlas {total:.2f} s")
    launches, rec = _timed_frames("village path", r, cfg)
    check(r._wavefront is not None, "village did not take the wavefront executor")
    _only("village path", launches, ("K2", "K3"))
    check(rec["shade_fused_share"] == 100.0,
          f"village path: fused shading share {rec['shade_fused_share']}%")
    log(f"village summary: set-up {r.setup_seconds:.3f} s, frame "
        f"{rec['frame_ms']:.3f} ms, {rec['mrays']:.3f} Mray/s, K2 "
        f"{rec['per_frame']['K2']:.2f} and K3 {rec['per_frame']['K3']:.2f} "
        f"launches per frame, alpha hops per frame {rec['alpha']['hops']:.2f}, "
        f"NEE samples dropped per frame {rec['nee_dropped']:.2f}")
    with env(RPTR_TRAVERSAL_V3="0"):
        r_cpu, _ = frame_setup("village", "cpu", MAIN_SIZE)
    village_mip_flips(r, cfg, r_cpu)
    return launches, phase_village_b3(r, cfg, r_cpu), rec["shade"]


def village_mip_flips(r, cfg, r_cpu, chunk=2):
    """The share of texture lookups whose mip level differs between the
    card and the CPU, on one 1080p chunk of the village's sample 0: the
    base-colour lookups of bounce 0, and of bounce 1 on the lanes whose
    paths hit the same triangle on both. The CPU scene ``r_cpu`` takes the
    K1 route (its plain walk is fast; hits equal K2's and K3's bitwise)."""
    import torch

    from realtimepathtracingresearchframework_tpu_torch.ops import integrator
    from realtimepathtracingresearchframework_tpu_torch.ops import pointsets
    from realtimepathtracingresearchframework_tpu_torch.ops import shade

    width, height = MAIN_SIZE
    dims = (float(width), float(height))
    out = {}
    orig = shade.sample_atlas
    # the lookups of the plain stage on both (the card's kernel equals it)
    fused_fns = shade.shade_hit, shade.shade_scatter
    for label, rr in ((DEVICE, r), ("cpu", r_cpu)):
        dev = rr.device
        cfg_i = rr._integrator_config(cfg.params)._replace(
            compact=False, compact_lanes=False)
        view = integrator.ViewBuffers(*(
            torch.from_numpy(a).to(dev) for a in cfg.camera.view_basis(width, height)))
        px, py, valid = (x[chunk] for x in rr._swizzle)
        state = pointsets.make_state(0, 0, 0, px, py, width)
        state, ro, rd = integrator.camera_setup(cfg_i, view, px, py, dims, state)
        fp = integrator.FrameParams()
        carry = integrator.initial_carry(
            ro, rd, state, valid,
            foot=integrator.camera_footprint0(cfg_i, fp, view, dims, rd))
        seen = []

        def spy(atlas, tid, uv, mip):
            seen.append((tid.cpu(), mip.cpu()))
            return orig(atlas, tid, uv, mip)

        shade.sample_atlas = spy
        shade.shade_hit = shade.shade_hit_plain
        shade.shade_scatter = shade.shade_scatter_plain
        try:
            visit, scatter = integrator._make_bounce_fns(rr.device_scene,
                                                         cfg_i, fp)
            rows = []
            for b in range(2):
                seen.clear()
                act = carry.active.cpu()
                carry, ctx = visit(carry)
                tid, mip = seen[0]  # the base-colour lookup
                rows.append((act & carry.active.cpu() & (tid >= 0),
                             torch.round(mip), ctx[0].x.cpu()))
                carry = scatter(carry, ctx, b)
        finally:
            shade.sample_atlas = orig
            shade.shade_hit, shade.shade_scatter = fused_fns
        out[label] = rows
    shares = []
    for b in range(2):
        (ok_k, mip_k, px_k), (ok_c, mip_c, px_c) = out[DEVICE][b], out["cpu"][b]
        same = ok_k & ok_c & (px_k == px_c)  # the same hit point on both
        flips = int((same & (mip_k != mip_c)).sum())
        shares.append((flips, int(same.sum())))
    log(f"village mip levels, card against CPU, chunk {chunk} of sample 0: "
        f"bounce 0 {shares[0][0]} of {shares[0][1]} textured lookups differ, "
        f"bounce 1 {shares[1][0]} of {shares[1][1]} (lanes with the same hit "
        f"point on both)")
    return shares


# label: (frame_setup scene, its options, IntegratorConfig changes,
# FrameParams changes, glass); every one on chunk 2 of the 1080p frame: the
# village (textured) and terrain500 (untextured), the village under RIS
# light selection (the binned light count of the emitter's MIS) and in the
# wavefront variant (the deferred shadow queue and its origin rule), cornell
# with a glass material (the transmission lobe) with the sun and sky off
# and in the glossy-only mode
SHADE_CASES = {
    "village": ("village", {"grid": 200}, {}, {}, False),
    "terrain500": ("terrain", {"grid": STREAM_GRID}, {}, {}, False),
    "village RIS": ("village", {"grid": 200, "ris": True}, {}, {}, False),
    "village wavefront": ("village", {"grid": 200}, {"wavefront": True}, {},
                          False),
    "cornell glass, sun off": ("cornell", {}, {"enable_sun_sky": False}, {},
                               True),
    "cornell glass, glossy only": ("cornell", {}, {}, {"glossy_only_mode": 1},
                                   True),
}
SHADE_CHUNK = 2


def _glass(ds):
    """``ds`` with its first material (cornell's white) a smooth glass, so
    that its lanes take the transmission lobe and pass the glossy-only
    mask (as tests/test_torch_fused_shade.py's ``glass``)."""
    from realtimepathtracingresearchframework_tpu_torch.ops import shade_common as sc

    m = ds.mat_packed.clone()
    m[sc._M_STRANS, 0] = 0.9
    m[sc._M_IOR, 0] = 1.5
    m[sc._M_ROUGH, 0] = 0.05
    m[sc._M_METAL, 0] = 0.0
    return ds._replace(mat_packed=m)


def _stage_bytes(run, out, x, ds, cfg, hit: bool) -> int:
    """The bytes one fused shading launch over the lanes of ``x`` needs:
    each lane's operands and results once (an array that two fields share,
    such as the base and transmission colours, once), and for shade_hit the
    attribute and material rows its lanes gather (the distinct rows, the
    columns it reads: textured 27 and 13, else 16 and 10) and on textured
    scenes the atlas (texels and descriptors) once."""
    import torch

    from realtimepathtracingresearchframework_tpu_torch.ops import shade
    from realtimepathtracingresearchframework_tpu_torch.ops import shade_common as sc

    n = x.active.shape[0]
    ops = run.keep[0] if hit else run.keep
    arrays = {a.data_ptr(): a for a in (*ops, *shade.fields(out).values())
              if a is not None}
    total = n * sum(a.element_size() for a in arrays.values())
    if hit:
        tri = torch.clamp(x.hit.tri, min=0).to(torch.int64)
        mid = ds.attr_packed[sc._A_MID][tri].to(torch.int64)
        cols = (27, 13) if cfg.has_textures else (16, 10)
        total += 4 * (cols[0] * int(torch.unique(tri).numel())
                      + cols[1] * int(torch.unique(mid).numel()))
        if cfg.has_textures:
            total += sum(a.numel() * a.element_size()
                         for a in (ds.atlas.texels, ds.atlas.desc))
    return total


def compare_shade(label, r, cfg, chunk, bounces=2, iters=20, cfg_changes=None,
                  fp_changes=None, ds=None):
    """Both fused shading kernels (csrc/shade.cu) against their plain
    versions on the card, on the bounce-0 and bounce-1 carries of chunk
    ``chunk`` of ``r``'s 1080p sample 0 (the monolith's bounce functions),
    lane for lane: for each kernel and bounce, the fields that differ with
    their lanes and largest difference, the kernel-only ms (raw launches),
    the plain version's ms and the bytes bound. ``cfg_changes`` and
    ``fp_changes`` change the integrator's configuration and frame
    parameters, ``ds`` stands in for ``r``'s device scene. Returns the
    rows."""
    import torch

    from realtimepathtracingresearchframework_tpu_torch.ops import integrator
    from realtimepathtracingresearchframework_tpu_torch.ops import pointsets
    from realtimepathtracingresearchframework_tpu_torch.ops import shade

    width, height = r.fb_width, r.fb_height
    dims = (float(width), float(height))
    icfg = r._integrator_config(cfg.params)._replace(
        compact=False, compact_lanes=False, **(cfg_changes or {}))
    check(shade.fused(icfg), f"{label}: the config takes the plain stage")
    fp = _frame_params(r, cfg)._replace(**(fp_changes or {}))
    ds = r.device_scene if ds is None else ds
    px, py, valid = (x[chunk] for x in r._swizzle)
    view = r._view(cfg.camera)
    state = pointsets.make_state(icfg.rng_variant, 0, fp.shot_offset, px, py,
                                 width, bufs=ds.rng)
    state, ro, rd = integrator.camera_setup(icfg, view, px, py, dims, state,
                                            bufs=ds.rng, fp=fp)
    carry = integrator.initial_carry(
        ro, rd, state, valid,
        foot=integrator.camera_footprint0(icfg, fp, view, dims, rd),
        wavefront=icfg.wavefront)
    rows = []
    bounce = [0]
    kernels = shade.shade_hit, shade.shade_scatter

    def both(name, kernel, plain, bind, hit):
        def fn(ds_, cfg_, fp_, x):
            got = kernel(ds_, cfg_, fp_, x)
            want = plain(ds_, cfg_, fp_, x)
            torch.cuda.synchronize()
            run, out = bind(ds_, cfg_, fp_, x)
            n = x.active.shape[0]
            nbytes = _stage_bytes(run, out, x, ds_, cfg_, hit)
            rows.append({
                "case": label, "kernel": name, "bounce": bounce[0], "lanes": n,
                "active": int(x.active.sum()),
                "differ": shade.differences(got, want),
                "ms": raw_ms(run, iters),
                "plain_ms": cuda_ms(lambda: plain(ds_, cfg_, fp_, x), 3),
                "bytes": nbytes, "bound_ms": nbytes / 3.35e12 * 1e3})
            return want

        return fn

    shade.reset_launches()
    shade.shade_hit = both("shade_hit", kernels[0], shade.shade_hit_plain,
                           shade.bind_hit, True)
    shade.shade_scatter = both("shade_scatter", kernels[1],
                               shade.shade_scatter_plain, shade.bind_scatter,
                               False)
    try:
        visit, scatter = integrator._make_bounce_fns(ds, icfg, fp)
        for b in range(bounces):
            bounce[0] = b
            carry, ctx = visit(carry)
            carry = scatter(carry, ctx, b)
    finally:
        shade.shade_hit, shade.shade_scatter = kernels
    for row in rows:
        log(f"fused shading, {label} chunk {chunk} bounce {row['bounce']}: "
            f"{row['kernel']} on {row['lanes']} lanes ({row['active']} "
            f"active): fields that differ from the plain version "
            f"{row['differ'] or 'none'}; kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.2f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bytes'] / row['lanes']:.1f} B a lane; share "
            f"{row['bound_ms'] / row['ms']:.3f})")
    log(f"fused shading, {label}: wrapper launches {shade.launches} "
        f"({bounces} of each compared)")
    check(shade.launches == dict.fromkeys(shade.launches, bounces),
          f"{label}: wrapper launches {shade.launches}, {bounces} of each "
          "expected")
    return rows


def phase_fused_shade():
    """The fused shading kernels against their plain versions on the
    bounce-0 and bounce-1 carries of each case of ``SHADE_CASES`` at 1080p
    (``compare_shade``). Fails where a field differs on more than
    ``SHADE_LANES_OFF`` of a launch's lanes. Returns the rows of every
    case."""
    from realtimepathtracingresearchframework_tpu_torch.profile_frame import (
        frame_setup,
    )

    out = {}
    renderers = {}
    for label, (scene, setup, cfg_changes, fp_changes, glass) in (
            SHADE_CASES.items()):
        key = (scene, tuple(sorted(setup.items())))
        if key not in renderers:
            renderers.clear()  # one scene on the card at a time
            renderers[key] = frame_setup(scene, DEVICE, MAIN_SIZE, **setup)
        r, cfg = renderers[key]
        out[label] = compare_shade(
            label, r, cfg, SHADE_CHUNK, cfg_changes=cfg_changes,
            fp_changes=fp_changes, ds=_glass(r.device_scene) if glass else None)
    renderers.clear()
    for label, rows in out.items():
        for row in rows:
            for name, (lanes, big) in row["differ"].items():
                check(lanes <= SHADE_LANES_OFF * row["lanes"],
                      f"{label} {row['kernel']} bounce {row['bounce']}: "
                      f"{name} differs on {lanes} lanes (largest {big})")
    return out


def phase_wavefront_path(mega):
    """Cornell at MAIN_SIZE, 1 spp, depth 9, through the PT_WAVEFRONT
    variant; then sample 0 against the PT_MEGAKERNEL renderer ``mega``'s
    sample 0. Returns (K1 launches, merged K1 launches) of the timed run."""
    from realtimepathtracingresearchframework_tpu_torch import goldens
    from realtimepathtracingresearchframework_tpu_torch.backend.renderer import (
        VARIANT_WAVEFRONT,
    )
    from realtimepathtracingresearchframework_tpu_torch.profile_frame import (
        frame_setup,
    )

    r, cfg = frame_setup("cornell", DEVICE, MAIN_SIZE, variant=VARIANT_WAVEFRONT)
    check(r.active_variant == VARIANT_WAVEFRONT, "PT_WAVEFRONT not selected")
    launches, rec = _timed_frames("wavefront cornell", r, cfg)
    _only("wavefront cornell", launches, ("K1",))
    merged = rec["merged"]["K1"]
    check(merged == launches["K1"],
          f"PT_WAVEFRONT: {launches['K1'] - merged} of {launches['K1']} K1 "
          "launches were not merged")
    frames = {}
    for label, rr in (("PT_MEGAKERNEL", mega), ("PT_WAVEFRONT", r)):
        rr.frame_id = 0  # sample 0, blended as the first sample
        rr.render(cfg)
        frames[label] = (rr.readback_accumulation()[..., :3], rr.last_frame_rays())
    (img_m, rays_m), (img_w, rays_w) = frames["PT_MEGAKERNEL"], frames["PT_WAVEFRONT"]
    vs = goldens.compare_card(img_w, img_m)
    log(f"wavefront cornell sample 0 vs PT_MEGAKERNEL sample 0: {vs}; rays "
        f"{rays_w} (megakernel {rays_m}); K1 {rec['per_frame']['K1']:.2f} "
        f"launches per frame, all merged")
    check(rays_w == rays_m, f"PT_WAVEFRONT rays {rays_w}, PT_MEGAKERNEL {rays_m}")
    check(vs["ok"], f"PT_WAVEFRONT frame off the PT_MEGAKERNEL frame: {vs}")
    return launches["K1"], merged


def phase_terrain_path():
    """procedural.terrain(grid=200) at MAIN_SIZE, 1 spp, depth 9, through the
    wavefront executor. Returns the launch counts of this run and its merged
    launch counts."""
    from realtimepathtracingresearchframework_tpu_torch.profile_frame import (
        frame_setup,
    )

    r, cfg = frame_setup("terrain", DEVICE, MAIN_SIZE)
    launches, rec = _timed_frames("terrain200 path", r, cfg)
    check(r._wavefront is not None, "terrain200 did not take the wavefront executor")
    _only("terrain200 path", launches, ("K2", "K3"))
    return launches, rec["merged"]


def phase_stream_paths():
    """procedural.terrain(grid=500) on the streamed route at MAIN_SIZE, 1 spp,
    depth 9, and at the bench's BENCH_SIZE, 1 spp, depth 3. Returns
    {label: (launches, merged launches, fused shading launches)} and the
    1080p path's (renderer, frame config)."""
    from realtimepathtracingresearchframework_tpu_torch.profile_frame import (
        frame_setup,
    )

    out, main = {}, None
    for label, size, depth, frames in (
        ("terrain500 1080p", MAIN_SIZE, 9, STREAM_FRAMES),
        ("terrain500 bench row", BENCH_SIZE, 3, TIMED_FRAMES),
    ):
        r, cfg = frame_setup("terrain", DEVICE, size, depth, grid=STREAM_GRID)
        bb = r.device_scene.bvh
        check(r._route.streamed, f"{label} is not on the streamed route")
        log(f"{label}: set-up (streamed pack and upload) {r.setup_seconds:.2f} s, "
            f"{bb.num_subtrees} subtrees of {bb.sub_leaves} leaves, "
            f"{bb.num_top_nodes} top nodes")
        launches, rec = _timed_frames(label, r, cfg, frames)
        check(r._wavefront is None, f"{label} took the wavefront executor")
        _only(label, launches, ("K4", "K5"))
        check(rec["shade_fused_share"] == 100.0,
              f"{label}: fused shading share {rec['shade_fused_share']}%")
        out[label] = launches, rec["merged"], rec["shade"]
        if main is None:
            main = (r, cfg)
    return out, main


def phase_stream_strategies(r500, cfg500):
    """This slice's streamed paths at MAIN_SIZE, 1 spp, depth 9: terrain500
    with 16-bit quantized tiles (options.quantized_geometry), the sorted K4
    walk for closest hits and one binned K5 round for shadow rays, both on
    int16 tiles; then the f32 pack (``r500``) through the ordered K4 walk
    and the quantized pack through the multislot dispatch
    (RPTR_STREAM_CLOSEST). Returns {label: record} and the quantized
    path's (renderer, frame config)."""
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_binned as tb,
    )
    from realtimepathtracingresearchframework_tpu_torch.profile_frame import (
        frame_setup,
    )

    out = {}
    t0 = time.perf_counter()
    rq, cfgq = frame_setup("terrain", DEVICE, MAIN_SIZE, 9, grid=STREAM_GRID,
                           quantized=True)
    total = time.perf_counter() - t0
    bq, bf = rq.device_scene.bvh, r500.device_scene.bvh
    check(rq._route.streamed and bq.quantized and rq._streamed_topo is None,
          "terrain500 quantized: not a quantized streamed pack")

    def nbytes(x):
        return x.numel() * x.element_size()

    log(f"terrain500 quantized 1080p: set-up (quantized streamed pack and "
        f"upload) {rq.setup_seconds:.2f} s (set_scene {total:.2f} s), "
        f"{bq.num_subtrees} subtrees; tiles {nbytes(bq.tri_tiles)} B int16 "
        f"against {nbytes(bf.tri_tiles)} B f32")
    launches, rec = _timed_frames("terrain500 quantized 1080p", rq, cfgq,
                                  STREAM_FRAMES)
    _only("terrain500 quantized 1080p", launches, ("K4", "K5"))
    out["quantized"] = dict(rec, launches=launches, setup_s=rq.setup_seconds)
    for label, r, cfg, strategy in (
        ("terrain500 1080p ordered", r500, cfg500, "ordered"),
        ("terrain500 quantized 1080p multislot", rq, cfgq, "multislot"),
    ):
        with env(RPTR_STREAM_CLOSEST=strategy):
            launches, rec = _timed_frames(label, r, cfg, 2)
            overflow = tb.multislot_overflow()
        _only(label, launches, ("K4", "K5"))
        modes = rec["modes"]
        if strategy == "ordered":
            check(modes["K4 ordered"] > 0, f"{label}: no ordered K4 launch")
        else:
            dispatches, over, live = overflow
            check(modes["multislot"] > 0, f"{label}: no multislot dispatch")
            log(f"{label}: K4 {rec['per_frame']['K4']:.2f} launches per frame "
                f"(every one a cleanup), K5 {rec['per_frame']['K5']:.2f}; "
                f"{dispatches} multislot dispatches, {over} of {live} live "
                f"rays ({over / max(live, 1):.5f}) past {tb.K_MAX} slots")
        log(f"{label} summary: frame {rec['frame_ms']:.3f} ms, "
            f"{rec['mrays']:.3f} Mray/s, K4 {rec['per_frame']['K4']:.2f} "
            f"launches per frame ({modes['K4 ordered'] / 3:.2f} ordered), K5 "
            f"{rec['per_frame']['K5']:.2f}")
        out[strategy] = dict(rec, launches=launches)
    return out, (rq, cfgq)


def _plain_ms(fn):
    """(result, ms) of one call of a plain version, timed with CUDA events."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _equal(a, b):
    """(mismatches, max |a - b|) over tuples of tensors compared bitwise."""
    if not isinstance(a, tuple):
        a, b = (a,), (b,)
    bad, err = 0, 0.0
    for x, y in zip(a, b):
        m, e = _bitwise(x, y)
        bad, err = bad + m, max(err, e)
    return bad, err


def _across(label, t_a, tri_a, t_b, tri_b):
    """Triangle ids equal except on exact-t ties, t bitwise equal
    everywhere. Returns the number of ties."""
    t_bad = _bitwise(t_a, t_b)[0]
    check(t_bad == 0, f"{label}: t differs on {t_bad} lanes")
    return int((tri_a != tri_b).sum())


def tile_real_rows(tiles, tile_rows):
    """Each leaf's real-row count in a field-major tile array (rows f of a
    leaf at ``tile_row + f`` hold field f of its 128 triangles; f32, or the
    int16 codes of a quantized pack): ``traverse.real_row_counts`` of the
    leaves at ``tile_rows`` (a 1-d int tensor), from the tiles' bits."""
    import torch

    from realtimepathtracingresearchframework_tpu_torch.ops import traverse

    idx = tile_rows.long()[:, None] + torch.arange(9, device=tiles.device)
    tris = tiles[idx].to(torch.float32).transpose(1, 2)  # (L, 128, 9)
    return traverse.real_row_counts(tris.reshape(-1, 9), 128)


def _pairs_rows(hits, counts):
    """(pairs, real rows) of a (rays, leaves) hit mask, each leaf weighing
    its real-row count."""
    return int(hits.sum()), int((hits.sum(0) * counts).sum())


def stream_bound(bb, rays, t_end, any_hit, sid_lane=None):
    """The bound of K4 and K5 on this queue (ms, bound_by, pairs): as
    ``bound`` over the streamed pack's leaf boxes, each pierced leaf
    weighing its real-row count (from the tiles' bits); with ``sid_lane``
    (a K5 launch) only the leaves of each lane's subtree count."""
    import torch

    from realtimepathtracingresearchframework_tpu_torch.ops import traverse_flat as tf
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_stream as ts,
    )

    aabbs, leaf_sid = ts.leaf_boxes(bb)
    nodes = bb.sub_nodes.view(-1, 8)
    leaf = torch.nonzero((nodes[:, 7] >= 0) & (nodes[:, 6] > 0)).squeeze(1)
    tile_row = (leaf // (bb.sub_node_rows * 16) * bb.sub_leaves
                + nodes[leaf, 7].long()) * 16
    counts = tile_real_rows(bb.tri_tiles, tile_row)
    if sid_lane is None:
        return bound(aabbs, ts.LEAF, rays, t_end, any_hit, counts)
    weight = torch.zeros(aabbs.shape[1], dtype=torch.int64, device=rays.device)
    weight[:counts.shape[0]] = counts
    seg = rays.clone()
    seg[7] = torch.minimum(rays[7], t_end)
    n, lpad = rays.shape[1], aabbs.shape[1]
    step = max(1, (1 << 23) // lpad)
    pairs = rows = 0
    for k in range(0, n, step):
        p, r = _pairs_rows(tf.ray_leaf_hits(seg[:, k:k + step], aabbs)
                           & (leaf_sid[None] == sid_lane[k:k + step, None]),
                           weight)
        pairs, rows = pairs + p, rows + r
    bytes_ms = n * (RAY_BYTES + 2 * HIT_BYTES) / PEAK_BYTES_PER_S * 1e3
    ops_ms = MT_FLOPS * rows / PEAK_F32_FLOPS * 1e3
    log(f"    bound over {pairs} ray-leaf pairs: {rows} real rows of "
        f"{ts.LEAF * pairs} padded, {max(bytes_ms, ops_ms):.4f} ms (over padded "
        f"leaves {max(bytes_ms, MT_FLOPS * ts.LEAF * pairs / PEAK_F32_FLOPS * 1e3):.4f} ms)")
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", pairs)


def _best_chunk(r, cfg, rows):
    """(c, packed primaries) of the frame's chunk with the most primary hits
    (the top chunks of the 16x16-tile order are mostly sky): sample 0's
    camera rays of each chunk of ``r`` (``_primaries``), counted by
    ``rows(packed rays)``, a kernel's hit rows (-1 on a miss)."""
    hits = [int((rows(_primaries(r, cfg, c)) >= 0).sum())
            for c in range(len(r._swizzle[0]))]
    c = int(np.argmax(hits))
    return c, _primaries(r, cfg, c)


def _primaries(r, cfg, c):
    """Sample 0's packed camera rays of chunk ``c`` of ``r``'s frame, dead
    on the padding lanes."""
    import torch

    from realtimepathtracingresearchframework_tpu_torch.ops import integrator
    from realtimepathtracingresearchframework_tpu_torch.ops import pointsets
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_resident as tr,
    )
    from realtimepathtracingresearchframework_tpu_torch.ops.intersect import T_MAX

    width, height = r.fb_width, r.fb_height
    view = integrator.ViewBuffers(*(
        torch.from_numpy(a).to(DEVICE) for a in cfg.camera.view_basis(width, height)))
    px, py, valid = (x[c] for x in r._swizzle)
    state = pointsets.make_state(0, 0, 0, px, py, width)
    _, ro, rd = integrator.camera_setup(
        integrator.IntegratorConfig(), view, px, py,
        (float(width), float(height)), state)
    return tr.pack_rays(ro, rd, 0.0, torch.where(valid, T_MAX, 0.0), 512)[0]


def _next_queues(prim, t, cfg, rng):
    """(bounce 1, sun shadow) packed queues from the hit points of the
    packed primaries ``prim`` at their closest ``t`` (2e32 on a miss):
    scattered directions and the scene's sun direction, dead where the
    primary missed."""
    import torch

    from realtimepathtracingresearchframework_tpu_torch.ops import integrator
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_resident as tr,
    )
    from realtimepathtracingresearchframework_tpu_torch.ops.intersect import T_MAX
    from realtimepathtracingresearchframework_tpu_torch.ops.vec3 import Vec3

    n = prim.shape[1]
    hit = t < 1e30
    p = [prim[k] + prim[3 + k] * torch.where(hit, t, 0.0) for k in range(3)]
    eps = (torch.sqrt(p[0] * p[0] + p[1] * p[1] + p[2] * p[2])
           + torch.where(hit, t, 0.0)) * integrator.RAY_EPSILON
    d = torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32)).to(DEVICE)
    d = d / torch.sqrt((d * d).sum(0))
    bounce, _ = tr.pack_rays(Vec3(*p), Vec3(*d), eps,
                             torch.where(hit, T_MAX, 0.0), 512)
    sun = np.asarray(cfg.scene_config.sun_dir, np.float32)
    sun = torch.from_numpy(sun / np.linalg.norm(sun)).to(DEVICE)
    shadow, _ = tr.pack_rays(Vec3(*p), Vec3(*(sun[k].expand(n) for k in range(3))),
                             eps, torch.where(hit, 2.0e16, 0.0), 512)
    return bounce, shadow


def compare_ordered(label, bb, rays, iters=5):
    """K4's ordered walk on one packed queue, coherence-sorted as the
    renderer dispatches it: against its plain version bitwise, and against
    the preorder walk (K4 sorted): t bitwise, triangles equal except on
    exact-t ties, which are counted. Returns its record."""
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_stream as ts,
    )

    srt, _ = ts._sort_operand(bb, rays)
    hk = ts.launch(bb, srt, False, ordered=True)
    hp, p_ms = _plain_ms(lambda: ts.plain(bb, srt, False, ordered=True))
    bad, err = _equal(hk, hp)
    ms = cuda_ms(lambda: ts.launch(bb, srt, False, ordered=True), iters)
    h0 = ts.launch(bb, srt, False)
    sorted_ms = cuda_ms(lambda: ts.launch(bb, srt, False), iters)
    t_k, tri_k = ts._out_to_hit(bb, hk, srt.shape[1], True)[:2]
    t_0, tri_0 = ts._out_to_hit(bb, h0, srt.shape[1], True)[:2]
    ties = _across(f"{label} ordered vs sorted", t_k, tri_k, t_0, tri_0)
    b_ms, b_by, pairs = stream_bound(bb, srt, t_k, False)
    log(f"  {label:34s} K4 ordered ({'int16' if bb.quantized else 'f32'} "
        f"tiles): {bad} vs plain not bitwise, {ms:.3f} ms (plain {p_ms:.1f}, "
        f"K4 sorted {sorted_ms:.3f} ms), vs K4 sorted t bitwise, {ties} "
        f"exact-t ties; bound {b_ms:.4f} ms by {b_by} ({pairs} ray-leaf pairs)")
    check(bad == 0, f"{label}: K4 ordered disagrees with its plain version")
    check(ties <= srt.shape[1] // 1000, f"{label}: {ties} ordered/sorted ties")
    return {"ms": ms, "plain_ms": p_ms, "max_abs_err": err, "bound_ms": b_ms,
            "bound_by": b_by, "sorted_ms": sorted_ms}


def compare_stream_queue(label, bb, fb, rays, rng, orays=None, iters=5):
    """K4 and K5 on one packed queue against their plain versions and
    against K1 (``fb``, resident). ``orays``: the any-hit segments, by
    default just short of (0.999 t) or past (1.001 t) each closest hit.
    Returns the K4 closest record and the closest t (caller order)."""
    import torch

    from realtimepathtracingresearchframework_tpu_torch.ops import traverse
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_binned as tb,
    )
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_stream as ts,
    )

    live = int((rays[7] > rays[6]).sum())
    srt, inv = ts._sort_operand(bb, rays)
    hk = ts.launch(bb, srt, False)
    hp, p_ms = _plain_ms(lambda: ts.plain(bb, srt, False))
    bad4, err = _equal(hk, hp)
    k4_ms = cuda_ms(lambda: ts.launch(bb, srt, False), iters)
    h4 = ts._out_to_hit(bb, tuple(x[inv] for x in hk), rays.shape[1], True)
    t4, tri4 = h4.t, h4.tri
    h1 = _k1(fb, rays, False)
    k1_ms = cuda_ms(lambda: _k1(fb, rays, False), iters)
    tri1 = traverse.map_rows_to_tris(fb, h1).tri
    ties41 = _across(f"{label} K4 vs K1", t4, tri4, h1.t, tri1)
    b_ms, b_by, pairs = stream_bound(bb, rays, t4, False)

    h5 = tb._run_rounds(bb, rays, 512, 2, False)
    p5, p5_ms = _plain_ms(lambda: tb._run_rounds(bb, rays, 512, 2, False, True))
    bad5, e5 = _equal(h5, p5)
    k5_ms = cuda_ms(lambda: tb._run_rounds(bb, rays, 512, 2, False), iters)
    tri5 = ts._out_to_hit(bb, h5, rays.shape[1], True).tri
    ties54 = _across(f"{label} K5 vs K4", h5[0], tri5, t4, tri4)
    ties51 = _across(f"{label} K5 vs K1", h5[0], tri5, h1.t, tri1)

    if orays is None:
        scale = torch.from_numpy(np.where(
            rng.uniform(size=rays.shape[1]) < 0.5, 0.999, 1.001
        ).astype(np.float32)).to(rays.device)
        orays = rays.clone()
        orays[7] = torch.where(rays[7] > rays[6],
                               torch.where(tri4 >= 0, t4 * scale, 1e30), rays[7])
    ok4 = ts.launch(bb, orays, True)
    op4, op4_ms = _plain_ms(lambda: ts.plain(bb, orays, True))
    occ4 = _equal(ok4, op4)[0]
    occ4_ms = cuda_ms(lambda: ts.launch(bb, orays, True), iters)
    ok5 = tb._run_rounds(bb, orays, 512, 1, True)
    op5, op5_ms = _plain_ms(lambda: tb._run_rounds(bb, orays, 512, 1, True, True))
    occ5 = _equal(ok5, op5)[0]
    occ5_ms = cuda_ms(lambda: tb._run_rounds(bb, orays, 512, 1, True), iters)
    b1 = _k1(fb, orays, True)
    occ1_ms = cuda_ms(lambda: _k1(fb, orays, True), iters)
    occ41, occ51 = _bitwise(ok4, b1)[0], _bitwise(ok5, b1)[0]
    log(f"  {label:22s} ({live} live): K4 closest sorted {bad4} vs plain not "
        f"bitwise, {k4_ms:.3f} ms (plain {p_ms:.1f}), K1 {k1_ms:.3f} ms, "
        f"hit {(tri4 >= 0).float().mean().item():.3f}, ties vs K1 {ties41}; "
        f"K5 closest 2 rounds {bad5} vs plain, {k5_ms:.3f} ms (plain "
        f"{p5_ms:.1f}), ties vs K4 {ties54}, vs K1 {ties51}; any-hit K4 "
        f"{occ4} vs plain, {occ41} vs K1, {occ4_ms:.3f} ms (plain "
        f"{op4_ms:.1f}), K5 1 round {occ5} vs plain, {occ51} vs K1, "
        f"{occ5_ms:.3f} ms (plain {op5_ms:.1f}), K1 {occ1_ms:.3f} ms, "
        f"blocked {ok4.float().mean().item():.3f}; K4 bound {b_ms:.4f} ms "
        f"by {b_by} ({pairs} ray-leaf pairs)")
    check(bad4 == 0 and occ4 == 0, f"{label}: K4 disagrees with its plain version")
    check(bad5 == 0 and occ5 == 0, f"{label}: K5 disagrees with its plain version")
    check(occ41 == 0 and occ51 == 0, f"{label}: K4/K5 any-hit disagrees with K1")
    return {"ms": k4_ms, "plain_ms": p_ms, "k1_ms": k1_ms,
            "max_abs_err": max(err, e5), "bound_ms": b_ms,
            "bound_by": b_by}, t4


def compare_k5_launch(label, bb, rays, t_end, shadow, iters=5):
    """One K5 launch, the first round of the binned dispatch of ``rays``,
    against its plain version. Returns its record."""
    import torch

    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_binned as tb,
    )

    n, dev = rays.shape[1], rays.device
    sb = tb.subtree_bounds(bb)
    s = sb.shape[0]
    srt, inv = tb._coherence_perm(bb, rays)
    entry = tb._entry_table(sb, srt)
    sid, _ = tb._next_subtree(
        entry, torch.full((n,), -2.0e32, device=dev),
        torch.full((n,), -1, dtype=torch.int32, device=dev), srt[7])
    sid_blk, prays, pbest, pos = tb.round_operand(
        srt, tb.miss_best(n, dev), sid, s, 512, tb.padded_lanes(n, s, 512))
    prays = prays.contiguous()
    pbest = tuple(x.contiguous() for x in pbest)
    k = tb.launch(bb, sid_blk, prays, pbest, 512, shadow)
    p, p_ms = _plain_ms(lambda: tb.plain(bb, sid_blk, prays, pbest, 512, shadow))
    bad, err = _equal(k, p)
    ms = cuda_ms(lambda: tb.launch(bb, sid_blk, prays, pbest, 512, shadow), iters)
    # the bound counts the leaves of each lane's one subtree up to its
    # closest hit, on the source lanes
    t_sorted = t_end[torch.argsort(inv)]
    b_ms, b_by, pairs = stream_bound(bb, srt, t_sorted, shadow,
                                     sid_lane=sid.to(torch.int64))
    log(f"  {label:22s} K5 launch ({'any-hit' if shadow else 'closest'}, "
        f"{prays.shape[1]} padded lanes, {int((sid_blk >= 0).sum())} bin "
        f"blocks): {bad} vs plain not bitwise, {ms:.3f} ms (plain {p_ms:.1f}), "
        f"bound {b_ms:.4f} ms by {b_by} ({pairs} ray-leaf pairs)")
    check(bad == 0, f"{label}: K5 launch disagrees with its plain version")
    return {"ms": ms, "plain_ms": p_ms, "max_abs_err": err, "bound_ms": b_ms,
            "bound_by": b_by}


def phase_streamed(r, cfg, smi):
    """K4 and K5 at the terrain500 1080p path's chunk shapes against their
    plain versions and K1. Returns {kernel: record}."""
    import torch

    from realtimepathtracingresearchframework_tpu_torch.models import procedural
    from realtimepathtracingresearchframework_tpu_torch.models.scene import Scene
    from realtimepathtracingresearchframework_tpu_torch.ops import bvh as bvh_mod
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_resident as tr,
    )
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_stream as ts,
    )

    rng = np.random.default_rng(500)
    bb = r.device_scene.bvh
    t0 = time.perf_counter()
    flat = Scene.from_vkr_scene(
        procedural.terrain(grid=STREAM_GRID)).flatten_world()
    fb = tr.pack_resident(bvh_mod.build_threaded_bvh(
        flat.v0, flat.e1, flat.e2, leaf_size=128, builder="sah"), DEVICE)
    log(f"K4, K5 at the terrain500 path's shapes ({bb.num_subtrees} subtrees, "
        f"{bb.num_top_nodes} top nodes), against K1 over a resident leaf-128 "
        f"BVH ({fb.num_nodes} nodes, built in {time.perf_counter() - t0:.1f} "
        f"s), {smi}:")
    c, prim = _best_chunk(r, cfg, lambda q: ts.launch(bb, q, False)[1])
    n = prim.shape[1]
    rec4, t = compare_stream_queue(f"primary chunk {c}", bb, fb, prim, rng)
    bounce, shadow = _next_queues(prim, t, cfg, rng)
    compare_stream_queue("bounce 1", bb, fb, bounce, rng)
    rec4["ordered"] = compare_ordered(f"K4 f32 primary chunk {c}", bb, prim)
    compare_ordered("K4 f32 bounce 1", bb, bounce)
    _, t_shadow = compare_stream_queue("sun shadow", bb, fb, shadow, rng,
                                       orays=shadow)
    rec5 = compare_k5_launch("sun shadow", bb, shadow, t_shadow, True)
    compare_k5_launch(f"primary chunk {c}", bb, prim, t, False)
    # K4's merged mode: the bounce-1 chunk and the sun shadow queue, each
    # coherence-sorted on its own (closest_and_occluded_streamed's sort)
    srt_b, srt_s = ts._sort_operand(bb, bounce)[0], ts._sort_operand(bb, shadow)[0]
    rays = torch.cat([srt_b, srt_s], dim=1).contiguous()
    t_b = ts.launch(bb, srt_b, False)[0]
    b_ms = (stream_bound(bb, srt_b, t_b, False)[0]
            + stream_bound(bb, srt_s, srt_s[7], True)[0])
    log(f"K4 merged mode, {smi}:")
    rec4["merged"] = compare_merged(
        "K4 terrain500 bounce 1 + sun shadow queue, sorted",
        lambda x, k: ts.merged_launch(bb, x, k),
        lambda x, k: ts.merged_plain(bb, x, k),
        lambda: (ts.launch(bb, srt_b, False), ts.launch(bb, srt_s, True)),
        rays, n, b_ms)
    return {"traverse_streamed": rec4, "traverse_binned": rec5}


def phase_streamed_quantized(r, cfg, smi):
    """K4 and K5 on the terrain500 quantized 1080p path's int16 tiles
    against their plain versions, at its primary chunk with the most hits
    and the sun shadow queue of its hit points: K4 closest sorted, K4's
    ordered walk, K5 closest (2 rounds) and one K5 launch closest and
    any-hit, the multislot dispatch and its one K5 launch; across them K4 =
    K5 = multislot except on exact-t ties. Returns the records of K4 and
    K5 on int16 tiles and of the multislot dispatch."""
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_binned as tb,
    )
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_stream as ts,
    )

    rng = np.random.default_rng(502)
    bb = r.device_scene.bvh
    check(bb.quantized, "the quantized path's pack is not int16")
    log(f"K4, K5 and the multislot dispatch on the terrain500 quantized pack "
        f"(int16 tiles, {bb.num_subtrees} subtrees), {smi}:")
    c, prim = _best_chunk(r, cfg, lambda q: ts.launch(bb, q, False)[1])
    n = prim.shape[1]
    label = f"primary chunk {c}"
    srt, inv = ts._sort_operand(bb, prim)
    hk = ts.launch(bb, srt, False)
    hp, p_ms = _plain_ms(lambda: ts.plain(bb, srt, False))
    bad, err = _equal(hk, hp)
    ms = cuda_ms(lambda: ts.launch(bb, srt, False), 5)
    h4 = ts._out_to_hit(bb, tuple(x[inv] for x in hk), n, True)
    b_ms, b_by, pairs = stream_bound(bb, prim, h4.t, False)
    log(f"  {label:22s} K4 int16 closest sorted: {bad} vs plain not bitwise, "
        f"{ms:.3f} ms (plain {p_ms:.1f}), hit "
        f"{(h4.tri >= 0).float().mean().item():.3f}, bound {b_ms:.4f} ms by "
        f"{b_by} ({pairs} ray-leaf pairs)")
    check(bad == 0, f"{label}: K4 int16 disagrees with its plain version")
    rec4 = {"ms": ms, "plain_ms": p_ms, "max_abs_err": err, "bound_ms": b_ms,
            "bound_by": b_by}
    rec4_ordered = compare_ordered(f"K4 int16 {label}", bb, prim)

    h5 = tb._run_rounds(bb, prim, 512, 2, False)
    p5, p5_ms = _plain_ms(lambda: tb._run_rounds(bb, prim, 512, 2, False, True))
    bad5 = _equal(h5, p5)[0]
    k5_ms = cuda_ms(lambda: tb._run_rounds(bb, prim, 512, 2, False), 3)
    tri5 = ts._out_to_hit(bb, h5, n, True).tri
    ties54 = _across(f"{label} K5 vs K4 int16", h5[0], tri5, h4.t, h4.tri)
    hm = tb._run_multislot(bb, prim, 512)
    pm, pm_ms = _plain_ms(lambda: tb._run_multislot(bb, prim, 512,
                                                    plain_versions=True))
    badm, errm = _equal(hm, pm)
    m_ms = cuda_ms(lambda: tb._run_multislot(bb, prim, 512), 3)
    trim = ts._out_to_hit(bb, hm, n, True).tri
    tiesm4 = _across(f"{label} multislot vs K4 int16", hm[0], trim, h4.t, h4.tri)
    tiesm5 = _across(f"{label} multislot vs K5 int16", hm[0], trim, h5[0], tri5)
    # the dispatch's one K5 launch, on its slot operand
    *_, overflow, sid_blk, prays, pbest, _ = tb.multislot_operand(bb, prim, 512)
    prays = prays.contiguous()
    pbest = tuple(x.contiguous() for x in pbest)
    k5m_ms = cuda_ms(lambda: tb.launch(bb, sid_blk, prays, pbest, 512, False), 3)
    lanes = prays.shape[1]
    del prays, pbest
    log(f"  {label:22s} K5 int16 closest 2 rounds {bad5} vs plain not bitwise, "
        f"{k5_ms:.3f} ms (plain {p5_ms:.1f}), {ties54} exact-t ties vs K4; "
        f"multislot ({tb.K_MAX} slots, {lanes} padded lanes, "
        f"{int(overflow.sum())} rays past them) {badm} vs plain not bitwise, "
        f"{m_ms:.3f} ms for the dispatch against {k5m_ms:.3f} ms for its one "
        f"K5 launch (plain {pm_ms:.1f}), {tiesm4} exact-t ties vs K4, "
        f"{tiesm5} vs K5")
    check(bad5 == 0, f"{label}: K5 int16 disagrees with its plain version")
    check(badm == 0, f"{label}: the multislot dispatch disagrees with its "
          "plain version")
    check(max(ties54, tiesm4, tiesm5) <= n // 1000, f"{label}: too many ties")
    rec_m = {"ms": m_ms, "plain_ms": pm_ms, "max_abs_err": errm,
             "k5_ms": k5m_ms, "bound_ms": b_ms, "bound_by": b_by}

    _, shadow = _next_queues(prim, h4.t, cfg, rng)
    t_sh = ts._out_to_hit(bb, ts.launch(bb, shadow, False), n, True).t
    rec5 = compare_k5_launch("quantized sun shadow", bb, shadow, t_sh, True)
    compare_k5_launch(f"quantized {label}", bb, prim, h4.t, False)
    blocked = tb._run_rounds(bb, shadow, 512, 1, True)
    pblocked = tb._run_rounds(bb, shadow, 512, 1, True, True)
    occ = _equal(blocked, pblocked)[0]
    log(f"  quantized sun shadow   K5 any-hit 1 round + K4 cleanup: {occ} vs "
        f"plain mismatched, blocked {blocked.float().mean().item():.3f}")
    check(occ == 0, "quantized sun shadow: K5 any-hit disagrees with plain")
    return rec4, rec4_ordered, rec5, rec_m


def phase_small_streamed():
    """procedural.terrain(grid=48) forced onto the streamed route, on the
    card against the port's CPU render; then the same renderers switched to
    16-bit quantized tiles by ``configure_for``."""
    from realtimepathtracingresearchframework_tpu_torch import goldens
    from realtimepathtracingresearchframework_tpu_torch.profile_frame import (
        frame_setup,
    )

    for quantized in (False, True):
        out = {}
        with env(RPTR_FORCE_STREAMED_TRAVERSAL="1"):
            for device in (DEVICE, "cpu"):
                counters = _counters()
                for reset, _ in counters.values():
                    reset()
                r, cfg = frame_setup("terrain", device, (48, 48), grid=48)
                if quantized:
                    ok = r.configure_for(
                        r.options.replace(quantized_geometry=True))
                    check(ok, "configure_for(quantized_geometry=True) failed")
                check(r._route.streamed
                      and r.device_scene.bvh.quantized == quantized,
                      f"terrain48: route {r._route}, quantized "
                      f"{r.device_scene.bvh.quantized}")
                rays = []
                for _ in range(2):
                    r.render(cfg)
                    rays.append(r.last_frame_rays())
                out[device] = (r.readback_accumulation()[..., :3], rays,
                               {k: read() for k, (_, read) in counters.items()})
        (img, rays, launched), (cpu_img, cpu_rays, _) = out[DEVICE], out["cpu"]
        vs_cpu = goldens.compare_card(img, cpu_img)
        label = f"terrain grid=48{' quantized' if quantized else ''}"
        log(f"{label} 48x48 depth 9, 2 frames, streamed route: vs port CPU "
            f"render {vs_cpu}; rays {rays} (CPU {cpu_rays}), launches {launched}")
        check(rays == cpu_rays, f"{label}: rays {rays}, CPU {cpu_rays}")
        check(vs_cpu["ok"], f"{label}: card render off the CPU render: {vs_cpu}")
        check(launched["K4"] > 0 and launched["K5"] > 0,
              f"{label} did not launch K4 and K5: {launched}")


# ---------------------------------------------------------------------------
# Two-level instancing: K6 and K7
# ---------------------------------------------------------------------------


def phase_tlas_paths():
    """The instanced paths of TLAS_PATHS through the port's Renderer, each
    with a TLAS update before every frame. Returns {label: (renderer, frame
    config, launches, record)}."""
    from realtimepathtracingresearchframework_tpu_torch.profile_frame import (
        frame_setup,
    )

    out = {}
    for label, num_inst, size, depth, frames, kernel in TLAS_PATHS:
        r, cfg = frame_setup("instanced", DEVICE, size, depth, num_inst=num_inst)
        ds = r.device_scene
        check(r._route.tlas.upper() == kernel,
              f"{label} took the {r._route.tlas} route, not {kernel}")
        if kernel == "K6":
            bb = ds.tlas_k6
            shape = (f"{bb.num_tlas_nodes} TLAS nodes, "
                     f"{bb.blas_nodes.shape[0]} BLAS nodes, "
                     f"{bb.tri_tiles.shape[0] // 16} leaf tiles")
        else:
            st, fr = ds.tlas_stream
            shape = (f"{fr.num_entries} entries of {st.num_chunks} chunks of "
                     f"{st.chunk_tris} tris, {fr.num_top_nodes} top nodes")
        log(f"{label}: set-up (BLAS, TLAS, pack and upload) "
            f"{r.setup_seconds:.2f} s, {len(r.scene.instances)} instances, "
            f"{r.scene.total_tris} instanced tris, {shape}")
        launches, rec = _timed_frames(label, r, cfg, frames, animate=True)
        check(r._wavefront is None, f"{label} took the wavefront executor")
        _only(label, launches, (kernel,))
        # two-level scenes shade through the plain stage (shade.fused)
        check(rec["shade_fused_share"] == 0.0,
              f"{label}: fused shading share {rec['shade_fused_share']}%")
        log(f"{label} summary: set-up {r.setup_seconds:.3f} s, TLAS update "
            f"{rec['update_ms']:.3f} ms, frame {rec['frame_ms']:.3f} ms "
            f"({rec['total_ms']:.3f} ms with the update), {rec['mrays']:.3f} "
            f"Mray/s, {kernel} {rec['per_frame'][kernel]:.2f} launches per frame")
        out[label] = (r, cfg, launches, rec)
    return out


def phase_tlas_slice():
    """This slice's instanced paths at MAIN_SIZE, 1 spp, depth 9:
    instanced_field(num_inst=500) through K6's ordered instance walk
    (RPTR_STREAM_CLOSEST=ordered), with a TLAS update before every frame;
    instanced_field(num_inst=INST_PAST_CAP) through K7, past the reference's
    cap of 2,048 (instance, chunk) entries. Returns {label: (renderer,
    frame config, launches, record)}."""
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_tlas as tt,
    )
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_tlas_stream as tts,
    )
    from realtimepathtracingresearchframework_tpu_torch.profile_frame import (
        frame_setup,
    )

    out = {}
    # a renderer of its own: the instanced500 path's stays at its last
    # animation frame for phase 12
    label = "instanced500 1080p ordered"
    r, cfg = frame_setup("instanced", DEVICE, MAIN_SIZE, 9, num_inst=500)
    check(r._route.tlas == "k6", f"{label} took the {r._route.tlas} route")
    with env(RPTR_STREAM_CLOSEST="ordered"):
        launches, rec = _timed_frames(label, r, cfg, 2, animate=True)
    _only(label, launches, ("K6",))
    check(rec["modes"]["K6 ordered"] > 0, f"{label}: no ordered K6 launch")
    log(f"{label} summary: frame {rec['frame_ms']:.3f} ms, {rec['mrays']:.3f} "
        f"Mray/s, K6 {rec['per_frame']['K6']:.2f} launches per frame, "
        f"{rec['modes']['K6 ordered'] / 3:.2f} of them ordered")
    out[label] = (r, cfg, launches, rec)

    label = f"instanced{INST_PAST_CAP} 1080p"
    t0 = time.perf_counter()
    r, cfg = frame_setup("instanced", DEVICE, MAIN_SIZE, 9,
                         num_inst=INST_PAST_CAP)
    total = time.perf_counter() - t0
    check(r._route.tlas == "k7", f"{label} took the {r._route.tlas} route")
    st, fr = r.device_scene.tlas_stream
    staged = tt.top_staged(tts.top_bytes(fr))
    log(f"{label}: set-up (BLAS, chunks, TLAS, pack and upload) "
        f"{r.setup_seconds:.2f} s (set_scene {total:.2f} s), "
        f"{len(r.scene.instances)} instances, {r.scene.total_tris} instanced "
        f"tris, {fr.num_entries} (instance, chunk) entries of "
        f"{st.num_chunks} chunks of {st.chunk_tris} tris (the reference's cap "
        f"2,048), {fr.num_top_nodes} top nodes, {tts.top_bytes(fr)} B of top "
        f"tree: K7 mode {'staged' if staged else 'global'}")
    check(fr.num_entries > REF_MAX_ENTRIES, f"{label}: {fr.num_entries} entries")
    launches, rec = _timed_frames(label, r, cfg, 2)
    _only(label, launches, ("K7",))
    log(f"{label} summary: frame {rec['frame_ms']:.3f} ms, {rec['mrays']:.3f} "
        f"Mray/s, K7 {rec['per_frame']['K7']:.2f} launches per frame, "
        f"{rec['modes']['K7 global'] / 3:.2f} of them global")
    out[label] = (r, cfg, launches, rec)
    return out


def compare_k6_ordered(label, ds, rays, iters=5):
    """K6's ordered instance walk on one packed queue: against its plain
    version bitwise, and against the preorder walk: t bitwise, triangles
    and instances equal except on exact-t ties, which are counted. Returns
    its record."""
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_tlas as tt,
    )

    bb = ds.tlas_k6
    staged, _, placed = _placement(ds, "K6")
    n = rays.shape[1]
    hk = tt.launch(bb, rays, False, ordered=True)
    hp, p_ms = _plain_ms(lambda: tt.plain(bb, rays, False, ordered=True))
    bad, err = _equal(hk, hp)
    shapes = _shapes(f"{label} K6 ordered",
                     lambda q, a, **kw: tt.launch(bb, q, a, ordered=True, **kw),
                     rays, False, hp, iters)
    ms = shapes[staged, tt.THREADS]
    pre_ms = cuda_ms(lambda: tt.launch(bb, rays, False), iters)
    h = tt.out_to_hit(bb, hk, n)
    h0 = tt.out_to_hit(bb, tt.launch(bb, rays, False), n)
    ties = _across(f"{label} K6 ordered vs preorder", h.t, h.tri, h0.t, h0.tri)
    ties_inst = int((h.inst != h0.inst).sum())
    b_ms, b_by, pairs = tlas_bound(ds, "K6", rays, h.t, False)
    log(f"  {label:34s} K6 ordered: {bad} vs plain not bitwise, {ms:.3f} ms "
        f"(plain {p_ms:.1f}, K6 preorder {pre_ms:.3f}), vs preorder t bitwise, "
        f"{ties} triangle and {ties_inst} instance exact-t ties; bound "
        f"{b_ms:.4f} ms by {b_by} ({pairs} ray-leaf pairs), {b_ms / ms:.4f} "
        f"of the bound; ran {placed}; ms by placement and block size: "
        f"{_shapes_text(shapes)}")
    check(bad == 0, f"{label}: K6 ordered disagrees with its plain version")
    check(max(ties, ties_inst) <= n // 1000, f"{label}: {ties} K6 ordered ties")
    return {"ms": ms, "plain_ms": p_ms, "max_abs_err": err, "bound_ms": b_ms,
            "bound_by": b_by, "preorder_ms": pre_ms}


def compare_k7_modes(label, r, cfg, smi, iters=3):
    """K7 with the top tree read from global memory against K7 with it
    staged in shared memory, on the path's primary chunk with the most
    hits, at each block size of TLAS_BLOCKS: closest against the plain
    version and any-hit against the global launch, bitwise, each timed.
    Returns the global mode's record."""
    import torch

    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_tlas as tt,
    )
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_tlas_stream as tts,
    )

    st, fr = r.device_scene.tlas_stream
    c, rays = _best_chunk(r, cfg, lambda q: tts.launch(st, fr, q, False)[1])
    n = rays.shape[1]
    _, _, placed = _placement(r.device_scene, "K7")
    log(f"K7 global against K7 staged on the {label} path's primary chunk "
        f"{c} ({fr.num_entries} entries, {tts.top_bytes(fr)} B of top tree), "
        f"{smi}:")
    launch = lambda q, a, **kw: tts.launch(st, fr, q, a, **kw)  # noqa: E731
    hp, p_ms = _plain_ms(lambda: tts.plain(st, fr, rays, False))
    shapes = _shapes(label, launch, rays, False, hp, iters)
    s_ms, g_ms = shapes[True, tt.THREADS], shapes[False, tt.THREADS]
    hit = tts.out_to_hit(st, fr, hp, n)
    scale = torch.where(torch.arange(n, device=rays.device) % 2 == 0, 0.999, 1.001)
    orays = rays.clone()
    orays[7] = torch.where(rays[7] > rays[6],
                           torch.where(hit.tri >= 0, hit.t * scale, 1e30),
                           rays[7])
    bg = tts.launch(st, fr, orays, True, staged=False)
    occ_shapes = _shapes(f"{label} any-hit", launch, orays, True, bg, iters)
    os_ms, og_ms = occ_shapes[True, tt.THREADS], occ_shapes[False, tt.THREADS]
    b_ms, b_by, pairs = tlas_bound(r.device_scene, "K7", rays, hit.t, False)
    log(f"  {label} primary chunk {c}: closest staged and global bitwise the "
        f"plain version, staged {s_ms:.3f} ms, global {g_ms:.3f} ms (plain "
        f"{p_ms:.1f}); any-hit staged bitwise global, staged {os_ms:.3f} ms, "
        f"global {og_ms:.3f} ms; hit {(hit.tri >= 0).float().mean().item():.3f}, "
        f"{len(set(hit.inst[hit.inst >= 0].tolist()))} instances hit; bound "
        f"{b_ms:.4f} ms by {b_by} ({pairs} ray-leaf pairs), global "
        f"{b_ms / g_ms:.4f} and staged {b_ms / s_ms:.4f} of the bound; the "
        f"launcher runs {placed}; closest ms by placement and block size: "
        f"{_shapes_text(shapes)}; any-hit: {_shapes_text(occ_shapes)}")
    return {"ms": g_ms, "plain_ms": p_ms, "max_abs_err": 0.0,
            "bound_ms": b_ms, "bound_by": b_by, "staged_ms": s_ms,
            "occ_ms": og_ms, "occ_staged_ms": os_ms}


def _tlas_fns(ds, kernel):
    """(launch, plain, decode) of the scene's two-level kernel on packed
    operands."""
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_tlas as tt,
    )
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_tlas_stream as tts,
    )

    if kernel == "K6":
        bb = ds.tlas_k6
        return (lambda q, a, **kw: tt.launch(bb, q, a, **kw),
                lambda q, a: tt.plain(bb, q, a),
                lambda out, n: tt.out_to_hit(bb, out, n))
    st, fr = ds.tlas_stream
    return (lambda q, a, **kw: tts.launch(st, fr, q, a, **kw),
            lambda q, a: tts.plain(st, fr, q, a),
            lambda out, n: tts.out_to_hit(st, fr, out, n))


def _placement(ds, kernel):
    """(staged, top-tree bytes, text) of the scene's two-level kernel: the
    placement its launcher picks, and the block size it runs."""
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_tlas as tt,
    )
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_tlas_stream as tts,
    )

    nbytes = (tt.tlas_bytes(ds.tlas_k6) if kernel == "K6"
              else tts.top_bytes(ds.tlas_stream[1]))
    staged = tt.top_staged(nbytes)
    return staged, nbytes, (
        f"{'staged' if staged else 'global'} ({nbytes} B top tree, staged up "
        f"to {tt.STAGE_MAX_BYTES} B), {tt.THREADS} threads per block")


def _shapes(label, launch, rays, any_hit, ref, iters):
    """Every placement of the top tree and block size of TLAS_BLOCKS for a
    two-level launch on one queue: each must equal ``ref`` (its plain
    version's result) bitwise; each timed. Returns {(staged, threads):
    ms}."""
    out = {}
    for staged in (True, False):
        for threads in TLAS_BLOCKS:
            bad = _equal(launch(rays, any_hit, staged=staged, threads=threads),
                         ref)[0]
            check(bad == 0, f"{label}: {'staged' if staged else 'global'}, "
                  f"{threads} threads: {bad} lanes not bitwise the plain version")
            out[staged, threads] = cuda_ms(
                lambda: launch(rays, any_hit, staged=staged, threads=threads),
                iters)
    return out


def _shapes_text(shapes):
    return ", ".join(f"{'staged' if st else 'global'} {th} {ms:.3f}"
                     for (st, th), ms in shapes.items())


def tlas_bound(ds, kernel, rays, t_end, any_hit):
    """The bound of K6 and K7 on this queue (ms, bound_by, pairs): as
    ``bound``, with the (ray, leaf) pairs counted in each instance's (K6)
    or entry's (K7) object space: the object ray's segment [tmin, min(tmax,
    t_end)] (world t) against the object-space boxes of that BLAS's or
    chunk's leaves, each pierced leaf weighing its real-row count (from
    the tiles' bits). K6 writes 4 more bytes per ray (the instance)."""
    import torch

    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_tlas as tt,
    )
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_tlas_stream as tts,
    )
    from realtimepathtracingresearchframework_tpu_torch.ops.intersect import (
        ray_aabb,
        safe_inv_dir,
    )
    from realtimepathtracingresearchframework_tpu_torch.ops.tlas import object_ray
    from realtimepathtracingresearchframework_tpu_torch.ops.vec3 import Vec3

    if kernel == "K6":
        bb = ds.tlas_k6
        boxes, table, tiles = tt.leaf_boxes(bb), bb.inst_table, bb.tri_tiles
    else:
        st, fr = ds.tlas_stream
        boxes, table, tiles = tts.leaf_boxes(st, fr), fr.entry_table, st.tri_tiles
    seg_end = torch.minimum(rays[7], t_end)
    ro, rd = Vec3(*rays[0:3]), Vec3(*rays[3:6])
    pairs = rows = 0
    counts = {}
    for row in table.tolist():
        key = int(row[13])
        b = boxes[key]
        if key not in counts:
            if kernel == "K6":
                nodes = bb.blas_nodes[key:key + int(row[14])]
                leaf = nodes[nodes[:, 7] >= 0, 7].long()
                tile_row = (int(row[15]) + leaf) * 16
            else:
                slots = st.node_rows * 16
                nodes = st.sub_nodes[key:key + st.node_rows].view(slots, 8)
                leaf = nodes[(nodes[:, 7] >= 0) & (nodes[:, 6] > 0), 7].long()
                tile_row = int(row[14]) + leaf * 16
            counts[key] = tile_real_rows(tiles, tile_row)
        o, d = object_ray(row, ro, rd)
        d3 = torch.stack(list(d), -1)[None]
        hit, _ = ray_aabb(torch.stack(list(o), -1)[None], safe_inv_dir(d3),
                          b[:, None, 0:3], b[:, None, 3:6], rays[6], seg_end,
                          d3 == 0.0)
        p, r = _pairs_rows(hit.T, counts[key])
        pairs, rows = pairs + p, rows + r
    n = rays.shape[1]
    out_bytes = 1 if any_hit else HIT_BYTES + (4 if kernel == "K6" else 0)
    bytes_ms = n * (RAY_BYTES + out_bytes) / PEAK_BYTES_PER_S * 1e3
    ops_ms = MT_FLOPS * rows / PEAK_F32_FLOPS * 1e3
    padded = MT_FLOPS * 128 * pairs / PEAK_F32_FLOPS * 1e3
    log(f"    bound over {pairs} ray-leaf pairs: {rows} real rows of "
        f"{128 * pairs} padded, {max(bytes_ms, ops_ms):.4f} ms (over padded "
        f"leaves {max(bytes_ms, padded):.4f} ms)")
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), pairs


def compare_tlas_queue(label, ds, kernel, rays, rng, orays=None, iters=5):
    """The scene's two-level kernel on one packed queue against its plain
    version, closest and any-hit (``orays``: by default segments just short
    of (0.999 t) or past (1.001 t) each closest hit). Returns the closest
    record, the decoded closest hits and the any-hit flags."""
    import torch

    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_tlas as tt,
    )

    launch, plain, decode = _tlas_fns(ds, kernel)
    staged, _, placed = _placement(ds, kernel)
    n = rays.shape[1]
    live = int((rays[7] > rays[6]).sum())
    hk = launch(rays, False)
    hp, p_ms = _plain_ms(lambda: plain(rays, False))
    bad, err = _equal(hk, hp)
    shapes = _shapes(label, launch, rays, False, hp, iters)
    k_ms = shapes[staged, tt.THREADS]
    hit = decode(hk, n)
    b_ms, b_by, pairs = tlas_bound(ds, kernel, rays, hit.t, False)
    if orays is None:
        scale = torch.from_numpy(np.where(
            rng.uniform(size=n) < 0.5, 0.999, 1.001).astype(np.float32)).to(rays.device)
        orays = rays.clone()
        orays[7] = torch.where(rays[7] > rays[6],
                               torch.where(hit.tri >= 0, hit.t * scale, 1e30), rays[7])
    bk = launch(orays, True)
    bp, op_ms = _plain_ms(lambda: plain(orays, True))
    occ = _equal(bk, bp)[0]
    occ_shapes = _shapes(label, launch, orays, True, bp, iters)
    occ_ms = occ_shapes[staged, tt.THREADS]
    ob_ms, ob_by, _ = tlas_bound(ds, kernel, orays, orays[7], True)
    log(f"  {label:34s} ({live} live): {kernel} closest {bad} vs plain not "
        f"bitwise, {k_ms:.3f} ms (plain {p_ms:.1f}), hit "
        f"{(hit.tri >= 0).float().mean().item():.3f}, "
        f"{len(set(hit.inst[hit.inst >= 0].tolist()))} instances hit, bound "
        f"{b_ms:.4f} ms by {b_by} ({pairs} ray-leaf pairs), {b_ms / k_ms:.4f} "
        f"of the bound; any-hit {occ} vs plain, {occ_ms:.3f} ms (plain "
        f"{op_ms:.1f}), blocked {bk.float().mean().item():.3f}, bound "
        f"{ob_ms:.4f} ms by {ob_by}, {ob_ms / occ_ms:.4f} of the bound; ran "
        f"{placed}; closest ms by placement and block size: "
        f"{_shapes_text(shapes)}; any-hit: {_shapes_text(occ_shapes)}")
    check(bad == 0 and occ == 0, f"{label}: {kernel} disagrees with its plain version")
    return ({"ms": k_ms, "plain_ms": p_ms, "max_abs_err": err, "bound_ms": b_ms,
             "bound_by": b_by, "occ_ms": occ_ms, "occ_plain_ms": op_ms,
             "shapes": shapes},
            hit, bk, orays)


def _tlas_queues(r, cfg, rng):
    """[(name, rays, any-hit rays or None)] of an instanced path at its last
    animation frame: the primary chunk with the most hits, a bounce-1 queue
    from its hit points (scattered directions, dead where the primary
    missed) and the sun shadow queue from the same points."""
    kernel = r._route.tlas.upper()
    launch, _, decode = _tlas_fns(r.device_scene, kernel)
    c, prim = _best_chunk(r, cfg, lambda q: launch(q, False)[1])
    t = decode(launch(prim, False), prim.shape[1]).t
    bounce, shadow = _next_queues(prim, t, cfg, rng)
    return [(f"primary chunk {c}", prim, None), ("bounce 1", bounce, None),
            ("sun shadow", shadow, shadow)]


def phase_tlas(paths, smi):
    """K6 and K7 against their plain versions on each instanced path's
    queues, K6's ordered walk on the instanced500 closest queues, and K6 =
    K7 on the instanced500 queues. Returns {kernel: record} of the 1080p
    paths' primary chunks ("K6 ordered" too)."""
    import torch

    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_tlas_stream as tts,
    )

    rng = np.random.default_rng(601)
    records = {}
    for label, (r, cfg, _, _) in paths.items():
        kernel = r._route.tlas.upper()
        log(f"{kernel} at the {label} path's shapes, {smi}:")
        queues = _tlas_queues(r, cfg, rng)
        results = []
        for qname, rays, orays in queues:
            rec, hit, blocked, oq = compare_tlas_queue(
                f"{label} {qname}", r.device_scene, kernel, rays, rng, orays)
            results.append((qname, rays, hit, blocked, oq))
            if label.endswith("1080p") and qname.startswith("primary"):
                records[kernel] = rec
        if kernel != "K6":
            continue
        # K6's ordered instance walk on the closest queues
        for qname, rays, _, _, _ in results[:2]:
            rec = compare_k6_ordered(f"{label} {qname}", r.device_scene, rays)
            if qname.startswith("primary"):
                records["K6 ordered"] = rec
        # K6 = K7: a K7 pack of the same scene at the same frame
        ds = r.device_scene
        st = tts.pack_tlas_stream_static(r._mesh_tris, device=DEVICE)
        fr = tts.pack_tlas_stream_frame(
            st, r._inst_binding[0], r.scene.instance_transforms(r._scene_frame),
            r._blas.tri_base)
        check(torch.equal(ds.tlas_k6.inst_tri_base[fr.entry_inst.long()],
                          fr.entry_tri_base), "K7 pack of instanced500 is off")
        for qname, rays, h6, b6, oq in results:
            n = rays.shape[1]
            h7 = tts.out_to_hit(st, fr, tts.launch(st, fr, rays, False), n)
            ties = _across(f"{label} {qname} K6 vs K7", h6.t, h6.tri, h7.t, h7.tri)
            ties_inst = int((h6.inst != h7.inst).sum())
            b7 = tts.launch(st, fr, oq, True)
            occ = _bitwise(b6, b7)[0]
            log(f"  {label} {qname}: K6 vs K7 ({fr.num_entries} entries, "
                f"{st.chunk_tris}-tri chunks) t bitwise, {ties} triangle and "
                f"{ties_inst} instance exact-t ties, any-hit {occ} mismatched")
            check(occ == 0, f"{label} {qname}: K6 and K7 any-hit disagree")
            check(ties <= n // 1000 and ties_inst <= n // 1000,
                  f"{label} {qname}: {ties} K6/K7 ties")
        del st, fr
        k6_k7_corner(label, r, cfg)
    return records


def k6_k7_corner(label, r, cfg, frame=2):
    """ROADMAP queue 3's grazing-corner entry (PR 6): K6 against a K7 pack
    of the same scene on every primary chunk of ``r``'s frame at animation
    ``frame``. The lanes whose t differs and those that tie in t with
    another triangle are counted, and the first few logged with both hits;
    no check (each kernel equals its plain version, and the two trees'
    leaves differ). Returns (t differs, ties)."""
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_tlas_stream as tts,
    )

    r.set_animation_frame(frame)
    st = tts.pack_tlas_stream_static(r._mesh_tris, device=DEVICE)
    fr = tts.pack_tlas_stream_frame(st, r._inst_binding[0],
                                    r.scene.instance_transforms(frame),
                                    r._blas.tri_base)
    launch6, _, decode6 = _tlas_fns(r.device_scene, "K6")
    differ = ties = lanes = 0
    shown = []
    for c in range(len(r._swizzle[0])):
        q = _primaries(r, cfg, c)
        n = q.shape[1]
        h6 = decode6(launch6(q, False), n)
        h7 = tts.out_to_hit(st, fr, tts.launch(st, fr, q, False), n)
        t_off = (_bits(h6.t) != _bits(h7.t)).cpu().numpy()
        tie = ((h6.tri != h7.tri) | (h6.inst != h7.inst)).cpu().numpy() & ~t_off
        differ, ties, lanes = differ + int(t_off.sum()), ties + int(tie.sum()), lanes + n
        for i in np.nonzero(t_off)[0][:max(0, 4 - len(shown))]:
            shown.append((c, int(i), float(h6.t[i]), int(h6.tri[i]), int(h6.inst[i]),
                          float(h7.t[i]), int(h7.tri[i]), int(h7.inst[i])))
    log(f"{label} at animation frame {frame}, K6 against K7 on {lanes} "
        f"primary lanes: t differs on {differ}, exact-t ties on {ties}; "
        f"(chunk, lane, K6 t, tri, inst, K7 t, tri, inst): {shown}")
    return differ, ties


def _alpha_field(r, cfg):
    """Re-set ``r``'s scene to instanced_field(num_inst=6) with alpha-cut
    textures on its rock and tree materials (a 4x4 checker of opaque and
    cut texels over each triangle's default uvs)."""
    import dataclasses

    from realtimepathtracingresearchframework_tpu_torch.models import procedural
    from realtimepathtracingresearchframework_tpu_torch.models.scene import Scene
    from realtimepathtracingresearchframework_tpu_torch.models.texture import (
        Texture,
    )

    rgba = np.full((4, 4, 4), 200, np.uint8)
    yy, xx = np.mgrid[0:4, 0:4]
    rgba[..., 3] = np.where((xx // 2 + yy // 2) % 2 == 0, 255, 0)
    vs = procedural.instanced_field(num_inst=6)
    mats = list(vs.materials)
    for k in (0, 1):  # rock, tree; the ground keeps its own material
        mats[k] = dataclasses.replace(
            mats[k], tex_base_color=Texture(4, 4, 37, mips=[rgba], srgb=False))
    vs.materials = mats
    r.set_scene(Scene.from_vkr_scene(vs), scene_config=cfg.scene_config)


def phase_small_instanced():
    """instanced_field(num_inst=6) through K6 and through K7, on the card
    against the port's CPU render; then the same with alpha-cut textures."""
    from realtimepathtracingresearchframework_tpu_torch import goldens
    from realtimepathtracingresearchframework_tpu_torch.ops import integrator
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_tlas as tt,
    )
    from realtimepathtracingresearchframework_tpu_torch.profile_frame import (
        frame_setup,
    )

    for alpha in (False, True):
        for kernel in ("K6", "K7"):
            out = {}
            old = tt.MAX_INSTANCES
            if kernel == "K7":
                tt.MAX_INSTANCES = 0
            try:
                for device in (DEVICE, "cpu"):
                    r, cfg = frame_setup("instanced", device, (48, 48), num_inst=6)
                    if alpha:
                        _alpha_field(r, cfg)
                        check(r._has_alpha, "alpha field without the alpha test")
                    counters = _counters()
                    for reset, _ in counters.values():
                        reset()
                    integrator.reset_alpha_counts()
                    check(r._route.tlas.upper() == kernel,
                          f"small instanced: {r._route}")
                    rays = []
                    for f in range(2):
                        r.set_animation_frame(f + 1)
                        r.render(cfg)
                        rays.append(r.last_frame_rays())
                    out[device] = (r.readback_accumulation()[..., :3], rays,
                                   {k: read() for k, (_, read) in counters.items()},
                                   integrator.alpha_hops)
            finally:
                tt.MAX_INSTANCES = old
            (img, rays, launched, hops), (cpu_img, cpu_rays, _, cpu_hops) = (
                out[DEVICE], out["cpu"])
            vs_cpu = goldens.compare_card(img, cpu_img)
            label = f"instanced_field(6){' alpha-cut' if alpha else ''}"
            log(f"{label} 48x48 depth 9, 2 animated frames, {kernel}: vs port "
                f"CPU render {vs_cpu}; rays {rays} (CPU {cpu_rays}), launches "
                f"{launched}, alpha hops {hops} (CPU {cpu_hops})")
            check(rays == cpu_rays, f"{label} {kernel}: rays {rays}, CPU {cpu_rays}")
            check(vs_cpu["ok"], f"{label} {kernel}: card render off the CPU "
                  f"render: {vs_cpu}")
            check(not alpha or hops > 0, f"{label} {kernel}: no alpha hops")
            _only(f"{label} {kernel}", launched, (kernel,))


# ---------------------------------------------------------------------------
# The v1 packet walk: K8a and K8b (RPTR_TRAVERSAL_V1)
# ---------------------------------------------------------------------------


def _same_bits(a, b):
    """Two float arrays equal bit for bit."""
    return a.shape == b.shape and bool((np.asarray(a, np.float32).view(np.int32)
                                        == np.asarray(b, np.float32).view(np.int32)).all())


def phase_v1_paths():
    """The V1 paths of V1_PATHS at MAIN_SIZE, 1 spp, depth 9, under
    RPTR_TRAVERSAL_V1=1: cornell through K8a, then its sample 0 against the
    K1 route's bitwise (both trees one node) and the PT_WAVEFRONT variant
    through merged K8a launches, its sample 0 against the megakernel's
    bitwise; terrain40 through K8a (a row-major table); terrain200 and the
    village through K8b. Returns {label: (renderer, frame config, launches,
    record)}, the wavefront path's under "v1 cornell PT_WAVEFRONT"."""
    from realtimepathtracingresearchframework_tpu_torch.backend.renderer import (
        VARIANT_WAVEFRONT,
    )
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_v1 as tv,
    )
    from realtimepathtracingresearchframework_tpu_torch.profile_frame import (
        frame_setup,
    )

    r_k1, _ = frame_setup("cornell", DEVICE, MAIN_SIZE)
    out = {}
    with env(RPTR_TRAVERSAL_V1="1"):
        for label, scene, grid, frames, kernel in V1_PATHS:
            r, cfg = frame_setup(scene, DEVICE, MAIN_SIZE, grid=grid)
            bvh = r.device_scene.bvh
            leaves = int((bvh.links[:, 1] >= 0).sum())
            log(f"{label}: {r.scene.total_tris} tris, leaf-128 tree of "
                f"{bvh.num_nodes} nodes, {leaves} leaves, {bvh.num_rows} padded "
                f"rows, {'row-major (Rp, 16)' if bvh.wide else 'field-major (16, Rp)'}"
                f" table; set-up (BVH build, pack and upload) "
                f"{r.setup_seconds:.2f} s")
            check(r._route.v1 and isinstance(bvh, tv.V1BVH)
                  and bvh.wide == (kernel == "K8a")
                  and bvh.num_rows == tv.LEAF * leaves,
                  f"{label}: route {r._route}, pack {type(bvh).__name__}")
            launches, rec = _timed_frames(label, r, cfg, frames)
            check(r._wavefront is None, f"{label} took the wavefront executor")
            _only(label, launches, (kernel,))
            log(f"{label} summary: frame {rec['frame_ms']:.3f} ms, "
                f"{rec['mrays']:.3f} Mray/s, {kernel} "
                f"{rec['per_frame'][kernel]:.2f} launches per frame")
            out[label] = (r, cfg, launches, rec)
            if scene != "cornell":
                continue
            # sample 0 on the K1 route and on V1: one 32-row leaf and one
            # 128-row leaf whose padded rows never hit
            check(r_k1.device_scene.bvh.num_nodes == bvh.num_nodes == 1,
                  "cornell: a tree is not one node")
            frames0 = {}
            for name, rr in (("K1", r_k1), ("V1", r)):
                rr.frame_id = 0
                rr.render(cfg)
                frames0[name] = (rr.readback_accumulation(), rr.last_frame_rays())
            same = _same_bits(frames0["K1"][0], frames0["V1"][0])
            log(f"{label}: sample 0 on V1 against the K1 route, bitwise equal "
                f"{same}; rays {frames0['V1'][1]} (K1 {frames0['K1'][1]})")
            check(same and frames0["K1"][1] == frames0["V1"][1],
                  "v1 cornell: sample 0 differs from the K1 route's")
            wlabel = "v1 cornell PT_WAVEFRONT"
            rw, cfgw = frame_setup("cornell", DEVICE, MAIN_SIZE,
                                   variant=VARIANT_WAVEFRONT)
            wl, wrec = _timed_frames(wlabel, rw, cfgw, frames)
            _only(wlabel, wl, ("K8a",))
            check(wrec["merged"]["K8"] == wl["K8a"],
                  f"{wlabel}: {wl['K8a'] - wrec['merged']['K8']} of "
                  f"{wl['K8a']} K8a launches were not merged")
            rw.frame_id = 0
            rw.render(cfgw)
            same_w = _same_bits(rw.readback_accumulation(), frames0["V1"][0])
            log(f"{wlabel}: sample 0 against the megakernel's, bitwise equal "
                f"{same_w}; rays {rw.last_frame_rays()}; K8a "
                f"{wrec['per_frame']['K8a']:.2f} launches per frame, all merged")
            check(same_w and rw.last_frame_rays() == frames0["V1"][1],
                  f"{wlabel}: sample 0 differs from the megakernel's")
            out[wlabel] = (rw, cfgw, wl, wrec)
    del r_k1
    return out


def _v1_fields(bvh, out):
    """(t, row, u, v) of a K8 output in either layout."""
    import torch

    f = out if bvh.wide else out.t()
    return (f[0].contiguous(), f[1].contiguous().view(torch.int32),
            f[2].contiguous(), f[3].contiguous())


def compare_v1(label, bvh, rays, any_hit, shadow_from=-1, iters=5):
    """K8 on one packed (8, n) queue (given to the kernel in its layout)
    against its plain version, the per-lane walk ``plain_lanes``, bitwise.
    Returns ((t, row, u, v), record) with the kernel-only ms (``raw_ms``),
    the wrapper's and the plain version's ms."""
    import torch

    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_v1 as tv,
    )

    op = rays if bvh.wide else rays.t().contiguous()
    k = tv.launch(bvh, op, any_hit, shadow_from)
    torch.cuda.synchronize()
    p, p_ms = _plain_ms(lambda: tv.plain_lanes(bvh, op, any_hit, shadow_from))
    kf, pf = _v1_fields(bvh, k), _v1_fields(bvh, p)
    bad, err = _equal(kf, pf)
    w_ms = cuda_ms(lambda: tv.launch(bvh, op, any_hit, shadow_from), iters)
    k_ms = raw_ms(tv.bind(bvh, op, any_hit, shadow_from)[0])
    name = "K8a" if bvh.wide else "K8b"
    mode = ("merged" if shadow_from >= 0 else "any-hit" if any_hit else "closest")
    live = int((rays[7] > rays[6]).sum())
    log(f"  {label}: {name} {mode} on {rays.shape[1]} lanes ({live} live): "
        f"{bad} values not bitwise its plain version; hit "
        f"{(kf[1] >= 0).float().mean().item():.3f}; kernel {k_ms:.4f} ms "
        f"(through the wrapper {w_ms:.4f} ms), plain {p_ms:.1f} ms")
    check(bad == 0, f"{label}: {name} {mode} disagrees with its plain version")
    return kf, {"ms": k_ms, "wrapper_ms": w_ms, "plain_ms": p_ms,
                "max_abs_err": err}


def _grazing(bvh, rays, lanes, row, t):
    """Whether each lane of ``lanes`` is grazing: the box of the leaf that
    holds its (packet) hit row ``row`` at ``t``, or of one of that leaf's
    ancestors, fails the lane's own slab test on [tmin, min(tmax, t)], in
    f32 as the walks compute it, so its own walk never tests that leaf. A
    lane without a hit row is not grazing."""
    bounds = bvh.bounds.cpu().numpy()
    skip, first = bvh.links[:, 0].cpu().numpy(), bvh.links[:, 1].cpu().numpy()
    node_of = {int(r): i for i, r in enumerate(first) if r >= 0}
    inner = np.nonzero(first < 0)[0]
    q = rays[:, lanes].cpu().numpy()
    out = []
    for j, (r, tj) in enumerate(zip(row.tolist(), t.tolist())):
        if r < 0:
            out.append(False)
            continue
        x = node_of[r // 128 * 128]
        path = list(inner[(inner <= x) & (skip[inner] > x)]) + [x]
        o, d = q[0:3, j], q[3:6, j]
        inv = (np.where(d >= 0, 1.0, -1.0).astype(np.float32)
               / np.maximum(np.abs(d), np.float32(1e-20)))
        cap = np.minimum(q[7, j], np.float32(tj))
        passes = True
        for node in path:
            t0 = (bounds[node, 0:3] - o) * inv
            t1 = (bounds[node, 3:6] - o) * inv
            tn = max(np.minimum(t0, t1).max(), q[6, j])
            tf = min(np.maximum(t0, t1).min(), cap)
            passes &= bool(tn <= tf)
        out.append(not passes)
    return out


def v1_against_packet(label, bvh, rays, kf, any_hit):
    """The lanes where the kernel's per-lane walk (K8a or K8b) and the
    packet walk (``plain``, the reference's function) differ on one queue,
    counted, each checked to be grazing (``_grazing``): t or row in closest
    mode, the blocked flag in any-hit mode. Returns the count."""
    import torch

    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_v1 as tv,
    )

    op = rays if bvh.wide else rays.t().contiguous()
    pf = _v1_fields(bvh, tv.plain(bvh, op, any_hit))
    if any_hit:
        differ = (kf[1] >= 0) != (pf[1] >= 0)
    else:
        differ = (_bits(kf[0]) != _bits(pf[0])) | (kf[1] != pf[1])
    lanes = torch.nonzero(differ).squeeze(1)
    graze = _grazing(bvh, rays, lanes, pf[1][lanes], pf[0][lanes])
    log(f"  {label}: {lanes.numel()} lanes where {'K8a' if bvh.wide else 'K8b'} "
        f"differs from the packet walk, {sum(graze)} of them grazing")
    check(all(graze), f"{label}: {graze.count(False)} lanes differ from the "
          "packet walk and are not grazing")
    return lanes.numel()


def _bits(x):
    import torch

    return x.contiguous().view(torch.int32)


def phase_v1_queues(paths, smi):
    """K8a and K8b on each V1 path's queues: the primary chunk with the most
    hits, a bounce-1 chunk from its hit points (scattered directions,
    unsorted, as V1 dispatches it) and the sun shadow queue of those hit
    points. Closest on the primary and bounce-1 chunks, any-hit on the
    shadow queue, the merged launch of the bounce-1 and shadow queues:
    each bitwise its plain version (K8a the packet walk, K8b the per-lane
    walk), timed with CUDA events beside the bound of each queue. On the
    K8b paths (terrain200, the village): K8b against K1's walk of the same
    leaf-128 tree (triangles and t equal on every lane, flags on the shadow
    queue), and against the packet walk, the lanes that differ counted and
    each shown to be grazing. Returns {"K8a": record, "K8b": record}, each
    with a "merged" record."""
    import torch

    from realtimepathtracingresearchframework_tpu_torch.ops import bvh as bvh_mod
    from realtimepathtracingresearchframework_tpu_torch.ops import traverse_flat as tf
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_resident as tr,
    )
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_v1 as tv,
    )

    rng = np.random.default_rng(20261017)
    records = {}
    for label, _scene, _grid, _frames, kernel in V1_PATHS:
        r, cfg, launches, rec = paths[label]
        bvh = r.device_scene.bvh
        rows = (bvh.tris[:, 0:9] if bvh.wide else bvh.tris[0:9].t()).cpu().numpy()
        aabbs = torch.from_numpy(tf.leaf_aabbs_for(rows, tv.LEAF)).to(DEVICE)

        def closest_rows(q, bvh=bvh):
            return _v1_fields(bvh, tv.launch(
                bvh, q if bvh.wide else q.t().contiguous(), False))[1]

        c, prim = _best_chunk(r, cfg, closest_rows)
        log(f"{label} queues ({smi}), primary chunk {c}:")
        hp, prim_rec = compare_v1(f"{label} primary chunk {c}", bvh, prim, False)
        b_ms, b_by, pairs = bound(aabbs, tv.LEAF, prim, hp[0], False,
                                  bvh.real_rows)
        bounce, shadow = _next_queues(prim, hp[0], cfg, rng)
        hb, bounce_rec = compare_v1(f"{label} bounce 1 (unsorted)", bvh, bounce,
                                    False)
        hs, shadow_rec = compare_v1(f"{label} sun shadow", bvh, shadow, True)
        nc = bounce.shape[1]
        merged = torch.cat([bounce, shadow], dim=1).contiguous()
        hm, merged_rec = compare_v1(f"{label} bounce 1 + sun shadow", bvh, merged,
                                    False, nc // tv.BLOCK)
        sep_bad = (_equal(tuple(x[:nc] for x in hm), hb)[0]
                   + _equal(tuple(x[nc:] for x in hm), hs)[0])
        op_b = bounce if bvh.wide else bounce.t().contiguous()
        op_s = shadow if bvh.wide else shadow.t().contiguous()
        sep_ms = (raw_ms(tv.bind(bvh, op_b, False)[0])
                  + raw_ms(tv.bind(bvh, op_s, True)[0]))
        bb_ms, bb_by, bb_pairs = bound(aabbs, tv.LEAF, bounce, hb[0], False,
                                       bvh.real_rows)
        bs_ms, bs_by, bs_pairs = bound(aabbs, tv.LEAF, shadow, shadow[7], True,
                                       bvh.real_rows)
        log(f"  {label}: merged launch against the two single-mode launches: "
            f"{sep_bad} values not bitwise; merged {merged_rec['ms']:.4f} ms, "
            f"separate {sep_ms:.4f} ms (kernel-only); {kernel} {rec['per_frame'][kernel]:.2f} "
            f"launches per frame; bounds: primary chunk {b_ms:.4f} ms by "
            f"{b_by} ({pairs} ray-leaf pairs), bounce 1 {bb_ms:.4f} ms by "
            f"{bb_by} ({bb_pairs}), sun shadow {bs_ms:.4f} ms by {bs_by} "
            f"({bs_pairs}), merged pair {bb_ms + bs_ms:.4f} ms")
        check(sep_bad == 0, f"{label}: merged launch differs from separate launches")
        # K1's per-ray walk over the same leaf-128 tree: K8's function
        flat = r.scene.flatten_world()
        tb = bvh_mod.thread_bvh(
            bvh_mod.build_bvh_sah(flat.v0, flat.e1, flat.e2, leaf_size=tv.LEAF),
            flat.v0, flat.e1, flat.e2)
        check(torch.equal(tv.pack_v1(tb, DEVICE).tris, bvh.tris),
              f"{label}: the rebuilt tree is not the renderer's")
        rb = tr.pack_resident(tb, DEVICE)
        for qname, q, h in (("primary", prim, hp), ("bounce 1", bounce, hb)):
            h1 = _k1(rb, q, False)
            differ = int(((h1.tri != h[1]) | (_bits(h1.t) != _bits(h[0]))).sum())
            log(f"  {label} {qname}: {differ} of {q.shape[1]} lanes where "
                f"{kernel}'s triangle or t differs from K1's walk of the same tree")
            check(differ == 0, f"{label} {qname}: {kernel} and K1 differ on "
                  f"{differ} lanes")
        b1 = _k1(rb, shadow, True)
        differ = int(((hs[1] >= 0) != b1).sum())
        log(f"  {label} sun shadow: {differ} lanes where {kernel}'s flag differs "
            f"from K1's")
        check(differ == 0, f"{label} sun shadow: {kernel} and K1 differ")
        graze = sum(v1_against_packet(f"{label} {qname}", bvh, q, h, a)
                    for qname, q, h, a in (("primary", prim, hp, False),
                                           ("bounce 1", bounce, hb, False),
                                           ("sun shadow", shadow, hs, True)))
        rec_graze = {"grazing_lanes": graze}
        if kernel in records:
            records[kernel]["grazing_lanes"] += graze
            continue
        records[kernel] = dict(prim_rec, launches=launches[kernel],
                               bound_ms=b_ms, bound_by=b_by, grazing_lanes=graze,
                               merged=dict(merged_rec, separate_ms=sep_ms,
                                           bound_ms=bb_ms + bs_ms))
    return records


def _query_rays(cfg, size, n, seed):
    """n rays from around the camera into its view, and a per-query t_max
    (short on a third of them), numpy."""
    rng = np.random.default_rng(seed)
    pos, du, dv, tl = (np.asarray(a, np.float32)
                       for a in cfg.camera.view_basis(*size))
    a, b = rng.uniform(size=(2, n, 1)).astype(np.float32)
    d = tl + a * du + b * dv
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = pos + rng.uniform(-0.05, 0.05, (n, 3)).astype(np.float32)
    t_max = np.where(np.arange(n) % 3 == 0, rng.uniform(0.5, 5.0, n),
                     2.0e32).astype(np.float32)
    return o.astype(np.float32), d.astype(np.float32), t_max


def phase_queries():
    """Renderer.render_ray_queries (closest-hit mode and the integrator
    mode) and render_aovs / readback_aov on the card against the port's CPU
    run of the same calls: cornell on the K1 and V1 routes, terrain200 on
    the K2 and V1 routes, procedural.terrain(grid=48) on the streamed route
    and procedural.instanced_field(num_inst=6) on the two-level route.
    Closest queries (the same rays on both): triangles equal, t, u, v
    within 1e-5; integrator queries: goldens.compare_card and alpha equal;
    AOVs (a second pass from a moved camera, so motion is non-zero): each
    buffer within 1e-4 on at least 99% of its pixels, the share
    compare_card allows, since the camera rays the pass makes on each
    device differ in their last bits (torch on the card divides by a
    scalar through its reciprocal) and a ray at an edge may hit another
    triangle."""
    from realtimepathtracingresearchframework_tpu_torch import goldens
    from realtimepathtracingresearchframework_tpu_torch.backend.params import (
        RenderParams,
    )
    from realtimepathtracingresearchframework_tpu_torch.backend.renderer import (
        VARIANT_MEGAKERNEL,
        FrameConfig,
    )
    from realtimepathtracingresearchframework_tpu_torch.models.camera import (
        OrientedCamera,
    )
    from realtimepathtracingresearchframework_tpu_torch.profile_frame import (
        frame_setup,
    )

    v1 = {"RPTR_TRAVERSAL_V1": "1"}
    cases = (
        ("cornell K1", "cornell", {}, {}, "K1"),
        ("cornell V1", "cornell", {}, v1, "K8a"),
        ("terrain200 K2", "terrain", {"grid": 200}, {}, "K2"),
        ("terrain200 V1", "terrain", {"grid": 200}, v1, "K8b"),
        ("terrain48 streamed", "terrain", {"grid": 48},
         {"RPTR_FORCE_STREAMED_TRAVERSAL": "1"}, "K4"),
        ("instanced6 two-level", "instanced", {"num_inst": 6}, {}, "K6"),
    )
    params = RenderParams(max_path_depth=3)
    for label, scene, kw, e, kernel in cases:
        got, secs = {}, {}
        for device in (DEVICE, "cpu"):
            t0 = time.perf_counter()
            counters = _counters()
            for reset, _ in counters.values():
                reset()
            with env(**e):
                r, cfg = frame_setup(scene, device, QUERY_SIZE, 3, **kw)
            o, d, t_max = _query_rays(cfg, QUERY_SIZE, N_QUERIES, 31)
            closest = r.render_ray_queries(o, d, t_max=t_max)
            n_i = N_QUERIES // 8
            radiance = r.render_ray_queries(o[:n_i], d[:n_i], t_max=t_max[:n_i],
                                            variant=VARIANT_MEGAKERNEL,
                                            params=params)
            pos, du, dv, tl = (np.asarray(a, np.float64)
                               for a in cfg.camera.view_basis(*QUERY_SIZE))
            look = tl + 0.5 * (du + dv)
            moved = FrameConfig(camera=OrientedCamera.look_at(
                pos + [0.05, 0.02, 0.0], pos + 10.0 * look / np.linalg.norm(look)
                + [0.1, 0.0, 0.0], fovy=50), params=cfg.params,
                scene_config=cfg.scene_config)
            r.render_aovs(cfg)
            r.render_aovs(moved)
            aovs = [r.readback_aov(k) for k in range(3)]
            got[device] = (closest, radiance, aovs,
                           {k: read() for k, (_, read) in counters.items()})
            secs[device] = time.perf_counter() - t0
        (ck, rk, ak, launched), (cc, rc, ac, _) = got[DEVICE], got["cpu"]
        same_tri = bool((ck[1] == cc[1]).all())
        not_bitwise = sum(int((np.asarray(a).view(np.int32)
                               != np.asarray(b).view(np.int32)).sum())
                          for a, b in zip((ck[0], ck[2], ck[3]),
                                          (cc[0], cc[2], cc[3])))
        close = all(np.allclose(a, b, rtol=1e-5, atol=1e-5)
                    for a, b in zip((ck[0], ck[2], ck[3]), (cc[0], cc[2], cc[3])))
        vs = goldens.compare_card(rk[None, :, :3], rc[None, :, :3])
        alpha_same = bool((rk[:, 3] == rc[:, 3]).all())
        aov_err = [float(np.abs(a.astype(np.float64) - b).max())
                   for a, b in zip(ak, ac)]
        aov_off = [float((~np.isclose(a, b, rtol=1e-4, atol=1e-4)).any(-1).mean())
                   for a, b in zip(ak, ac)]
        aov_ok = max(aov_off) <= 0.01
        motion = float(np.abs(ak[2][..., 0:2]).max())
        log(f"queries {label}: closest triangles equal {same_tri} (hit "
            f"{(ck[1] >= 0).mean():.3f}), t/u/v within 1e-5 {close} "
            f"({not_bitwise} values not bitwise); integrator queries vs the "
            f"CPU {vs}, alpha equal {alpha_same}; AOVs: share of pixels off by "
            f"more than 1e-4 per buffer {aov_off}, max |card - CPU| {aov_err}, "
            f"max |motion| {motion:.4f};"
            f" card launches {launched}; seconds, set-up included: card "
            f"{secs[DEVICE]:.1f}, CPU {secs['cpu']:.1f}")
        check(same_tri and close, f"queries {label}: closest hits off the CPU's")
        check(vs["ok"] and alpha_same,
              f"queries {label}: integrator queries off the CPU's: {vs}")
        check(aov_ok and motion > 0.0, f"queries {label}: AOVs off the CPU's")
        check(launched[kernel] > 0, f"queries {label} did not launch {kernel}")


# ---------------------------------------------------------------------------
# Slice B2: the RNG variants, the monolith's carry compaction and animated
# flattened scenes
# ---------------------------------------------------------------------------

RNG_VARIANTS = (("bn", 1), ("sobol", 2), ("zsbl", 3))  # options.rng_variant
RNG_FRAMES = 2  # timed frames of each RNG variant's cornell path
FLAT_ANIM_LANES = 8_192  # lanes of the refit pack's queues held to plain
FLAT_ANIM_FLAT_LANES = 262_144  # lanes of the rebuilt pack's queues
FLAT_ANIM_PATHS = (  # label, instances, size, depth, timed frames, kernels,
    # the BVH update each frame takes (567,104 tris refit past the rebuild
    # budget of 500,000, 78,086 rebuilt within it)
    ("instanced600 flattened bench row", 600, BENCH_SIZE, 3, 4, ("K4", "K5"),
     "refit"),
    ("instanced100 flattened 1080p", 100, MAIN_SIZE, 9, 2, ("K2", "K3"),
     "rebuild"),
)


ONE_CHUNK = (960, 544)  # 2,040 16x16 tiles: one chunk of 522,240 lanes


def _device_kernels(r, cfg):
    """(device kernels, their summed device ms) of one frame of ``r`` at
    ONE_CHUNK (the eager kernels of one of the 1080p frame's four chunks)
    under torch.profiler (device activity only); ``r`` is set back to its
    size after."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    size = (r.fb_width, r.fb_height)
    r.initialize(*ONE_CHUNK)
    check(len(r._swizzle[0]) == 1, f"{ONE_CHUNK} is not one chunk")
    r.render(cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        r.render(cfg)
        torch.cuda.synchronize()
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    r.initialize(*size)
    return len(kern), sum(e.device_time for e in kern) / 1e3


def phase_rng_paths():
    """Cornell at MAIN_SIZE, 1 spp, depth 9 under the BN, Sobol and Z-Sobol
    RNG variants with the reference's pointset tables: timed frames, the
    device kernels of one profiled chunk beside the uniform variant's, K1's
    launches; K1 must launch and no other. Returns {variant: launches}."""
    from realtimepathtracingresearchframework_tpu_torch.profile_frame import (
        frame_setup,
    )

    r, cfg = frame_setup("cornell", DEVICE, MAIN_SIZE)
    uniform = _device_kernels(r, cfg)
    del r
    out = {}
    for name, variant in RNG_VARIANTS:
        r, cfg = frame_setup("cornell", DEVICE, MAIN_SIZE, rng_variant=variant)
        check(r.device_scene.rng.reference_tables,
              f"rng {name}: the reference's pointset tables were not taken")
        launches, rec = _timed_frames(f"rng {name} cornell", r, cfg,
                                      frames=RNG_FRAMES)
        _only(f"rng {name} cornell path", launches, ("K1",))
        kernels, device_ms = _device_kernels(r, cfg)
        log(f"rng {name} summary: frame {rec['frame_ms']:.3f} ms, "
            f"{rec['mrays']:.3f} Mray/s, device kernels per {ONE_CHUNK} chunk "
            f"{kernels} (uniform {uniform[0]}), their device ms {device_ms:.3f} "
            f"(uniform {uniform[1]:.3f}), K1 launches per frame "
            f"{rec['per_frame']['K1']:.2f}")
        out[name] = launches
        del r
    return out


def phase_village_compacted(smi):
    """The village at MAIN_SIZE, 1 spp, depth 9 through PT_WAVEFRONT: the
    monolith with its default carry compaction. Timed frames with the
    live-count reads of their compacted bounces; sample 0 with compaction and with
    RPTR_COMPACT_LANES=0 on the same renderer (equal rays, the frames
    bitwise or within the reference's rtol 3e-5 / atol 1e-7, which is
    printed); then K2 and K3 against their plain versions and K1 on the
    first compacted queue (bounce 1's closest queue, presorted). Returns the
    path's launch counts."""
    import torch

    from realtimepathtracingresearchframework_tpu_torch.backend.renderer import (
        VARIANT_WAVEFRONT,
    )
    from realtimepathtracingresearchframework_tpu_torch.ops import traverse_flat as tf
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_resident as tr,
    )
    from realtimepathtracingresearchframework_tpu_torch.profile_frame import (
        frame_setup,
    )
    from realtimepathtracingresearchframework_tpu_torch.utils import profiling

    r, cfg = frame_setup("village", DEVICE, MAIN_SIZE, variant=VARIANT_WAVEFRONT)
    icfg = r._integrator_config(cfg.params)
    check(icfg.compact_lanes and icfg.wavefront and not r._use_wavefront_host(icfg),
          f"village PT_WAVEFRONT: not the compacted monolith ({icfg})")
    launches, rec = _timed_frames("village PT_WAVEFRONT compacted", r, cfg,
                                  frames=1)
    _only("village PT_WAVEFRONT compacted path", launches, ("K2", "K3"))
    reads = profiling.host_syncs["compaction_live"]
    log(f"village compacted: {reads} live-count reads of compacted bounces "
        f"in 2 frames of {len(r._swizzle[0])} chunks; K2 "
        f"{rec['per_frame']['K2']:.2f} and K3 {rec['per_frame']['K3']:.2f} "
        f"launches per frame, of them merged {rec['merged']}")
    check(reads > 0, "village compacted: no compacted bounce")
    imgs, rays = {}, {}
    for flag in ("1", "0"):
        with env(RPTR_COMPACT_LANES=flag):
            r.reset_accumulation()
            r.render(cfg)
            imgs[flag] = r.readback_accumulation()
            rays[flag] = r.last_frame_rays()
    diff = np.abs(imgs["1"].astype(np.float64) - imgs["0"])
    bitwise = bool(np.array_equal(imgs["1"], imgs["0"]))
    close = bool(np.allclose(imgs["1"], imgs["0"], rtol=3e-5, atol=1e-7))
    log(f"village PT_WAVEFRONT sample 0, compacted against RPTR_COMPACT_LANES=0: "
        f"rays {rays['1']} and {rays['0']}, bitwise {bitwise}, within rtol 3e-5 "
        f"atol 1e-7 {close}, max abs difference {diff.max():.3e}, "
        f"{int((diff > 0).any(-1).sum())} pixels differ")
    check(rays["1"] == rays["0"], "village: compaction changed the ray count")
    check(close, "village: the compacted frame is off the uncompacted one")
    captured = []
    orig = tf.closest_hit_precull

    def spy(bvh, ro, rd, t_min, t_max, **kw):
        if not captured:
            captured.append((ro, rd, t_min, t_max))
        return orig(bvh, ro, rd, t_min, t_max, **kw)

    tf.closest_hit_precull = spy
    try:
        r.reset_accumulation()
        r.render(cfg)
    finally:
        tf.closest_hit_precull = orig
    ro, rd, t_min, t_max = captured[0]
    queue, n = tr.pack_rays(ro, rd, t_min, t_max, 1024)
    live = int((queue[7] > queue[6]).sum())
    log(f"K2 and K3 on the village's first compacted queue (bounce 1, {live} "
        f"live of a {n}-lane prefix, presorted), {smi}:")
    compare_flat_queue("village compacted bounce 1", r.device_scene.bvh, queue,
                       ((tf.K2, 128), (tf.K3, 128)), np.random.default_rng(16))
    del r
    torch.cuda.empty_cache()
    return launches


def phase_flat_animation(smi):
    """Animated flattened scenes (options.use_tlas off): each FLAT_ANIM_PATHS
    path with a BVH refit or rebuild (set_animation_frame) before every
    frame: set-up seconds, tlas_update_seconds per frame, frame ms, the
    path's kernels (and no other); then at animation frame 3, on the refit
    streamed pack K4 and K5 against their plain versions and K1 (primaries
    and their sun shadow queue), and on the rebuilt flat pack K2 and K3
    against theirs (primaries and the sorted bounce 1). Returns {label:
    launches}."""
    import torch

    from realtimepathtracingresearchframework_tpu_torch.ops import bvh as bvh_mod
    from realtimepathtracingresearchframework_tpu_torch.ops import traverse_flat as tf
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_resident as tr,
    )
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_stream as ts,
    )
    from realtimepathtracingresearchframework_tpu_torch.profile_frame import (
        frame_setup,
    )

    out = {}
    for label, inst, size, depth, frames, kernels, update in FLAT_ANIM_PATHS:
        t0 = time.perf_counter()
        r, cfg = frame_setup("instanced", DEVICE, size, depth=depth,
                             num_inst=inst, use_tlas=False)
        total = time.perf_counter() - t0
        log(f"{label}: {r._flat.num_tris} flattened tris, route {r._route}, "
            f"set-up (build, pack and upload) {r.setup_seconds:.2f} s, "
            f"set_scene with flatten {total:.2f} s")
        launches, rec = _timed_frames(label, r, cfg, frames=frames, animate=True)
        _only(f"{label} path", launches, kernels)
        check(r.animation_update == update,
              f"{label}: {r.animation_update}, not a {update}")
        log(f"{label} summary: set-up {r.setup_seconds:.3f} s, "
            f"tlas_update_seconds per frame {rec['marker_ms']} ms ({update}), "
            f"frame {rec['frame_ms']:.3f} ms, {rec['mrays']:.3f} Mray/s, "
            f"launches per frame {rec['per_frame']}")
        r.set_animation_frame(3)
        bb = r.device_scene.bvh
        rng = np.random.default_rng(3000 + inst)
        if r._route.streamed:
            flat = r._flat
            t0 = time.perf_counter()
            fb = tr.pack_resident(bvh_mod.build_threaded_bvh(
                flat.v0, flat.e1, flat.e2, leaf_size=128), DEVICE)
            log(f"K4, K5 on the {label}'s refit pack at frame 3 "
                f"({bb.num_subtrees} subtrees), against K1 over a resident "
                f"leaf-128 BVH (built in {time.perf_counter() - t0:.1f} s), "
                f"{smi}:")
            c, prim = _best_chunk(r, cfg, lambda q: ts.launch(bb, q, False)[1])
            # the middle FLAT_ANIM_LANES lanes of the chunk: the plain
            # versions take seconds per 10,000 lanes
            mid = prim.shape[1] // 2 - FLAT_ANIM_LANES // 2
            prim = prim[:, mid:mid + FLAT_ANIM_LANES].contiguous()
            _, t = compare_stream_queue(f"primary chunk {c}, {FLAT_ANIM_LANES} "
                                        "lanes", bb, fb, prim, rng)
            # the sun shadow queue from those hit points (the plain walks
            # of an incoherent bounce-1 queue on this pack take 30-40 s)
            _, shadow = _next_queues(prim, t, cfg, rng)
            _, t_shadow = compare_stream_queue("sun shadow", bb, fb, shadow, rng,
                                               orays=shadow)
            compare_k5_launch("sun shadow", bb, shadow, t_shadow, True)
            del fb
        else:
            check(isinstance(bb, tf.FlatBVH), f"{label}: not the flat-cull route")
            prim, bounce, _ = flat_queues(r, cfg, rng)
            # the middle of the frame's primaries and the head of the sorted
            # bounce-1 queue (its live lanes first)
            mid = prim.shape[1] // 2 - FLAT_ANIM_FLAT_LANES // 2
            prim = prim[:, mid:mid + FLAT_ANIM_FLAT_LANES].contiguous()
            bounce = bounce[:, :FLAT_ANIM_FLAT_LANES].contiguous()
            log(f"K2, K3 on the {label}'s rebuilt flat pack at frame 3 "
                f"({bb.num_leaves} leaves of {bb.leaf_size}), "
                f"{FLAT_ANIM_FLAT_LANES} lanes of its queues, {smi}:")
            compare_flat_queue("frame primaries", bb, prim, ((tf.K2, 128),), rng)
            compare_flat_queue("bounce 1 sorted", bb, bounce, ((tf.K3, 128),), rng)
        out[label] = launches
        del r
        torch.cuda.empty_cache()
    return out


def phase_small_flat_animation():
    """procedural.instanced_field(num_inst=6) flattened at 48x48, depth 9,
    at animation frame 2: rebuilt on the K1 route, refit on the streamed
    route (RPTR_FORCE_STREAMED_TRAVERSAL=1, rebuild budget 0) and on the
    flat-cull route (RPTR_TRAVERSAL_V3=1): on the card against the port's
    CPU render, equal rays and goldens.compare_card; the route's kernels
    launch and no other."""
    from realtimepathtracingresearchframework_tpu_torch import goldens
    from realtimepathtracingresearchframework_tpu_torch.profile_frame import (
        frame_setup,
    )

    cases = (("K1 rebuild", {}, None, ("K1",)),
             ("streamed refit", {"RPTR_FORCE_STREAMED_TRAVERSAL": "1"}, 0,
              ("K4", "K5")),
             ("flat-cull refit", {"RPTR_TRAVERSAL_V3": "1"}, 0, ("K2", "K3")))
    for label, kv, budget, kernels in cases:
        out = {}
        with env(**kv):
            for device in (DEVICE, "cpu"):
                counters = _counters()
                for reset, _ in counters.values():
                    reset()
                r, cfg = frame_setup("instanced", device, (48, 48), depth=9,
                                     num_inst=6, use_tlas=False)
                if budget is not None:
                    r.options = r.options.replace(rebuild_triangle_budget=budget)
                r.set_animation_frame(2)
                r.render(cfg)
                out[device] = (r.readback_accumulation()[..., :3],
                               r.last_frame_rays(),
                               {k: read() for k, (_, read) in counters.items()},
                               r.animation_update)
        (img, rays, launches, update), (cpu_img, cpu_rays, _, _) = (
            out[DEVICE], out["cpu"])
        vs_cpu = goldens.compare_card(img, cpu_img)
        log(f"instanced_field(6) flattened 48x48 depth 9 at frame 2, {label} "
            f"({update}): vs port CPU render {vs_cpu}; rays {rays} (CPU "
            f"{cpu_rays}), launches {launches}")
        check(rays == cpu_rays, f"flattened {label}: rays {rays}, CPU {cpu_rays}")
        check(vs_cpu["ok"], f"flattened {label}: card render off the CPU's")
        _only(f"flattened {label}", launches, kernels)


# ---------------------------------------------------------------------------
# Slice B3: the zero-direction slab test on the axis-aligned queue, binned
# RIS light selection, thin-lens DoF, the debug and ray-stats images and the
# debug views
# ---------------------------------------------------------------------------

B3_LANES = {"cornell": 16_384, "village": 8_192}  # chunk lanes held to the CPU
DEBUG_LANES = 4_096  # chunk lanes of the village's debug images held to it
B3_CHUNK = 2  # the 1080p chunk those lanes come from
DOF = dict(aperture=0.05, focus=3.2)  # cornell's lens, focused on its centre
B3_ROUNDS = 2  # rounds of (A, B, B, A) frames of the walls' comparisons
AXIS_LEAVES = (32, 64, 128)
AXIS_WALKS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8a", "K8b")


def _frame_params(r, cfg):
    """The FrameParams ``Renderer.render`` gives sample 0 of ``cfg``."""
    from realtimepathtracingresearchframework_tpu_torch.ops import integrator

    p = cfg.params
    return integrator.FrameParams(
        rr_path_depth=int(p.rr_path_depth),
        glossy_only_mode=int(p.glossy_only_mode), sample_offset=0,
        shot_offset=r.shot_offset, pixel_radius=float(p.pixel_radius),
        bump_scale=float(cfg.scene_config.bump_scale),
        aperture_radius=float(p.aperture_radius),
        focus_distance=float(p.focus_distance))


def _trace_lanes(r, cfg, lanes, debug_mode=0):
    """Sample 0 of the first ``lanes`` lanes of chunk B3_CHUNK of ``r``'s
    frame through the monolithic ``trace_paths`` (the pass's camera set-up
    and footprint): its outputs on the host (rgb (lanes, 3), alpha, rays,
    and with ``debug_mode`` the DEBUG_MODE_* count)."""
    import torch

    from realtimepathtracingresearchframework_tpu_torch.ops import integrator
    from realtimepathtracingresearchframework_tpu_torch.ops import pointsets

    icfg = r._integrator_config(cfg.params)._replace(
        debug_mode=debug_mode, wavefront=False)
    fp = _frame_params(r, cfg)
    dims = (float(r.fb_width), float(r.fb_height))
    px, py, valid = (x[B3_CHUNK][:lanes] for x in r._swizzle)
    view = r._view(cfg.camera)
    ds = r.device_scene
    state = pointsets.make_state(icfg.rng_variant, 0, fp.shot_offset, px, py,
                                 r.fb_width, bufs=ds.rng)
    state, ro, rd = integrator.camera_setup(icfg, view, px, py, dims, state,
                                            bufs=ds.rng, fp=fp)
    out = integrator.trace_paths(
        ds, icfg, fp, ro, rd, state, lane_mask=valid,
        footprint0=integrator.camera_footprint0(icfg, fp, view, dims, rd))
    if r.device.type == "cuda":
        torch.cuda.synchronize()
    rgb = torch.stack(list(out[0]), -1)
    return (rgb.cpu().numpy(), *(x.cpu().numpy() for x in out[1:]))


def _lanes_vs_cpu(label, r, r_cpu, cfg, lanes):
    """``_trace_lanes`` on the card against the CPU, as goldens.compare_card
    holds a frame: equal ray counts, at most 1% of lanes over 1e-3 and a
    relative L1 error of at most 1e-4. Returns the card lanes' rays."""
    from realtimepathtracingresearchframework_tpu_torch import goldens

    t0 = time.perf_counter()
    card = _trace_lanes(r, cfg, lanes)
    t1 = time.perf_counter()
    cpu = _trace_lanes(r_cpu, cfg, lanes)
    vs = goldens.compare_card(card[0][:, None], cpu[0][:, None])
    rays, cpu_rays = int(card[2].sum()), int(cpu[2].sum())
    log(f"  {label}: {lanes} lanes of chunk {B3_CHUNK}, sample 0, card "
        f"against the port's CPU run: {vs}; rays {rays} (CPU {cpu_rays}); "
        f"card {t1 - t0:.2f} s, CPU {time.perf_counter() - t1:.2f} s")
    check(rays == cpu_rays, f"{label}: rays {rays} on the card, {cpu_rays} "
          "on the CPU")
    check(vs["ok"], f"{label}: card lanes off the CPU's: {vs}")
    return rays


def _walls(label, runs, rounds=B3_ROUNDS):
    """Frame walls (CUDA events around ``render`` and a sync) of two
    renderers in turns, (A, B, B, A) ``rounds`` times after a warm-up
    frame each: ``runs`` is ((name, renderer, FrameConfig), (name, ...)).
    Logs and returns {name: [ms, ...]}."""
    import torch

    out = {name: [] for name, _, _ in runs}
    for _, r, cfg in runs:
        r.render(cfg)
    torch.cuda.synchronize()
    order = [runs[0], runs[1], runs[1], runs[0]] * rounds
    for name, r, cfg in order:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        r.render(cfg)
        end.record()
        torch.cuda.synchronize()
        out[name].append(start.elapsed_time(end))
    log(f"{label} frame walls in turns (A, B, B, A) x {rounds}: " + "; ".join(
        f"{name} {[round(x, 3) for x in ms]} ms, median "
        f"{float(np.median(ms)):.3f}, spread {min(ms):.3f}-{max(ms):.3f}"
        for name, ms in out.items()))
    return out


def phase_cornell_b3(mega, cfg_mega):
    """Cornell at MAIN_SIZE, depth 9, with thin-lens DoF: timed frames (K1
    and no other), its walls in turns with the pinhole main path
    ``mega``'s, and B3_LANES lanes of a chunk against the CPU; the pinhole
    frame's ray-stats image with the same lanes of the CPU's exactly; the
    RT_DEBUG and GBUFFER views at MAIN_SIZE (one ray a pixel) and at 64x36
    against the CPU's (within 1e-4 on 99% of the pixels, as the AOVs of
    phase 16). Returns the DoF path's launches."""
    from realtimepathtracingresearchframework_tpu_torch.backend.renderer import (
        VARIANT_GBUFFER,
        VARIANT_MEGAKERNEL,
        VARIANT_RT_DEBUG,
    )
    from realtimepathtracingresearchframework_tpu_torch.profile_frame import (
        frame_setup,
    )

    r, cfg = frame_setup("cornell", DEVICE, MAIN_SIZE, **DOF)
    check(r._integrator_config(cfg.params).enable_dof, "cornell DoF is off")
    launches, rec = _timed_frames("cornell DoF", r, cfg, frames=2)
    _only("cornell DoF path", launches, ("K1",))
    walls = _walls("cornell pinhole (A) against DoF (B)",
                   (("pinhole", mega, cfg_mega), ("DoF", r, cfg)))
    r_cpu, _ = frame_setup("cornell", "cpu", MAIN_SIZE, **DOF)
    _lanes_vs_cpu("cornell DoF", r, r_cpu, cfg, B3_LANES["cornell"])
    log(f"cornell DoF summary: frame {rec['frame_ms']:.3f} ms (pinhole median "
        f"{float(np.median(walls['pinhole'])):.3f}, DoF "
        f"{float(np.median(walls['DoF'])):.3f} in turns), {rec['rays']} rays, "
        f"K1 {rec['per_frame']['K1']:.2f} launches per frame")
    # the ray-stats image: the whole frame on the card, and the chunk's
    # lanes of it against the CPU's per-lane counts
    mega_cpu, _ = frame_setup("cornell", "cpu", MAIN_SIZE)
    mega.reset_accumulation()  # sample 0, as the CPU lanes trace it
    t0 = time.perf_counter()
    stats = mega.render_ray_stats(cfg_mega)
    ms = (time.perf_counter() - t0) * 1e3
    lanes = B3_LANES["cornell"]
    cpu = _trace_lanes(mega_cpu, cfg_mega, lanes)[2]
    px, py, valid = (x[B3_CHUNK][:lanes].cpu().numpy() for x in mega._swizzle)
    card = np.where(valid, stats[py, px], 0)
    differ = int((card != np.where(valid, cpu, 0)).sum())
    log(f"cornell ray-stats image {stats.shape} {stats.dtype} in {ms:.1f} ms: "
        f"{int(stats.sum())} rays, mean {float(stats.mean()):.3f} a pixel, max "
        f"{int(stats.max())}; {differ} of {lanes} chunk lanes differ from the "
        "CPU's")
    check(stats.dtype == np.int32 and stats.shape == MAIN_SIZE[::-1],
          f"ray stats: {stats.dtype} {stats.shape}")
    check(differ == 0, f"cornell ray stats: {differ} lanes off the CPU's")
    # the debug views: one first-hit ray a pixel through the AOV pass
    views = {}
    for variant in (VARIANT_RT_DEBUG, VARIANT_GBUFFER):
        mega.set_variant(variant)
        t0 = time.perf_counter()
        mega.render(cfg_mega)
        img = mega.readback_accumulation()
        views[variant] = (time.perf_counter() - t0) * 1e3
        check(img.shape == (*MAIN_SIZE[::-1], 4) and np.isfinite(img).all(),
              f"{variant}: image {img.shape} not finite")
        small = {}
        for device in (DEVICE, "cpu"):
            rr, cc = frame_setup("cornell", device, QUERY_SIZE,
                                 variant=variant)
            rr.render(cc)
            small[device] = rr.readback_framebuffer()
        close = np.isclose(small[DEVICE], small["cpu"], rtol=0, atol=1e-4)
        share = float(close.all(-1).mean())
        log(f"{variant} {MAIN_SIZE[0]}x{MAIN_SIZE[1]} in {views[variant]:.1f} "
            f"ms (readback included), mean {float(img.mean()):.5f}; at "
            f"{QUERY_SIZE}: {share:.4f} of pixels within 1e-4 of the CPU's")
        check(share >= 0.99, f"{variant}: {share} of pixels within 1e-4")
    mega.set_variant(VARIANT_MEGAKERNEL)
    return launches


def phase_village_b3(r, cfg, r_cpu):
    """The village at MAIN_SIZE, depth 9, under binned RIS light selection
    (options.light_sampling_variant RIS, applied by configure_for): timed
    frames (K2 and K3 and no other; NEE samples dropped per frame under the
    limit), its walls in turns with the uniform selection's on the same
    renderer, and B3_LANES lanes of a chunk against the CPU; then, uniform
    again, the debug images of modes 1-3 over the whole frame, with
    DEBUG_LANES lanes of the chunk against the CPU's exactly. Returns the
    RIS path's launches."""
    from realtimepathtracingresearchframework_tpu_torch.backend.params import (
        LIGHT_SAMPLING_VARIANT_NONE,
        LIGHT_SAMPLING_VARIANT_RIS,
    )

    def select(variant):
        for rr in (r, r_cpu):
            check(rr.configure_for(rr.options.replace(
                light_sampling_variant=variant)), "configure_for refused")

    select(LIGHT_SAMPLING_VARIANT_RIS)
    icfg = r._integrator_config(cfg.params)
    check(icfg.use_light_bins, "village RIS: binned selection is off")
    log(f"village RIS: {r._num_lights} lights in bins of {icfg.light_bin_size}")
    launches, rec = _timed_frames("village RIS", r, cfg, frames=2)
    _only("village RIS path", launches, ("K2", "K3"))
    _lanes_vs_cpu("village RIS", r, r_cpu, cfg, B3_LANES["village"])
    # the walls in turns on this renderer: each switch of the selection
    # (configure_for) re-lays the lights and drops the wavefront executor,
    # so a warm-up frame follows it
    walls = {"uniform": [], "RIS": []}
    for name in ("uniform", "RIS", "RIS", "uniform") * B3_ROUNDS:
        select(LIGHT_SAMPLING_VARIANT_RIS if name == "RIS"
               else LIGHT_SAMPLING_VARIANT_NONE)
        walls[name].append(_warm_wall(r, cfg))
    log(f"village uniform (A) against RIS (B) frame walls, each after a "
        f"warm-up frame, in turns (A, B, B, A) x {B3_ROUNDS}: " + "; ".join(
            f"{name} {[round(x, 3) for x in ms]} ms, median "
            f"{float(np.median(ms)):.3f}, spread {min(ms):.3f}-{max(ms):.3f}"
            for name, ms in walls.items()))
    log(f"village RIS summary: frame {rec['frame_ms']:.3f} ms, "
        f"{rec['mrays']:.3f} Mray/s, NEE samples dropped per frame "
        f"{rec['nee_dropped']:.2f}, K2 {rec['per_frame']['K2']:.2f} and K3 "
        f"{rec['per_frame']['K3']:.2f} launches per frame")
    select(LIGHT_SAMPLING_VARIANT_NONE)
    r.reset_accumulation()  # sample 0, as the chunk's lanes trace it
    for mode in (1, 2, 3):
        for rr in (r, r_cpu):
            rr.options = rr.options.replace(debug_mode=mode)
        t0 = time.perf_counter()
        img = r.render_debug_image(cfg)
        ms = (time.perf_counter() - t0) * 1e3
        card = _trace_lanes(r, cfg, DEBUG_LANES, mode)[3]
        cpu = _trace_lanes(r_cpu, cfg, DEBUG_LANES, mode)[3]
        px, py, valid = (x[B3_CHUNK][:DEBUG_LANES].cpu().numpy()
                         for x in r._swizzle)
        differ = int((card != cpu).sum())
        in_image = int((np.where(valid, img[py, px], 0) != card).sum())
        log(f"village debug mode {mode}: image {img.shape} {img.dtype} in "
            f"{ms:.1f} ms, sum {int(img.sum())}, max {int(img.max())}; "
            f"{DEBUG_LANES} chunk lanes: {differ} differ from the CPU's, "
            f"{in_image} from the image")
        check(img.dtype == np.int32 and img.shape == MAIN_SIZE[::-1],
              f"debug image: {img.dtype} {img.shape}")
        check(differ == 0 and in_image == 0,
              f"village debug mode {mode}: lanes off the CPU's or the image")
    for rr in (r, r_cpu):
        rr.options = rr.options.replace(debug_mode=0)
    return launches


def _warm_wall(r, cfg):
    """One warm-up frame, then one frame's wall in ms (CUDA events around
    ``render`` and a sync)."""
    import torch

    r.render(cfg)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    r.render(cfg)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def _axis_terrain():
    """The 24x24 height-field soup of tests/test_traverse_kernels.py::
    _terrain: (v0, e1, e2) f32, 1,058 triangles."""
    x = np.linspace(-4.0, 4.0, 24, dtype=np.float32)
    xx, zz = np.meshgrid(x, x)
    yy = 0.6 * np.sin(1.3 * xx) * np.cos(0.9 * zz)
    p = np.stack([xx, yy, zz], axis=-1)
    a, b = p[:-1, :-1].reshape(-1, 3), p[:-1, 1:].reshape(-1, 3)
    c, d = p[1:, :-1].reshape(-1, 3), p[1:, 1:].reshape(-1, 3)
    v0, v1, v2 = np.concatenate([a, b]), np.concatenate([b, d]), np.concatenate([c, c])
    return v0, v1 - v0, v2 - v0


def _axis_rays(fb, rng, n=1024):
    """tests/test_torch_flat_cull.py::_axis_rays: x = 0 directions from
    origins on the leaf boxes' min-x or max-x faces (and on z faces, box
    edges, on 30% of the lanes), above the scene, straight down or at
    (0, -0.6, +-0.8)."""
    box = fb.aabbs[:, :fb.num_leaves].cpu().numpy()
    leaf = rng.integers(0, fb.num_leaves, n)
    lo, hi = box[0:3, leaf], box[3:6, leaf]
    x = np.where(rng.uniform(size=n) < 0.5, lo[0], hi[0])
    z = rng.uniform(lo[2], hi[2])
    edge = rng.uniform(size=n) < 0.3
    z = np.where(edge, np.where(rng.uniform(size=n) < 0.5, lo[2], hi[2]), z)
    y = np.full(n, box[4, :fb.num_leaves].max() + 1.0)
    ro = np.stack([x, y, z], 1).astype(np.float32)
    down = rng.uniform(size=n) < 0.5
    sz = np.where(rng.uniform(size=n) < 0.5, 0.8, -0.8)
    rd = np.stack([np.zeros(n), np.where(down, -1.0, -0.6),
                   np.where(down, 0.0, sz)], 1).astype(np.float32)
    return ro, rd


def _axis_structures(leaf_size, device):
    """Every walk's structure over ``_axis_terrain`` on ``device``: the
    flat pack at ``leaf_size`` (K1, K2, K3), the streamed pack (K4, K5),
    one instance under the identity transform (K6, K7), the v1 tables in
    both layouts (K8a row-major, K8b field-major)."""
    from realtimepathtracingresearchframework_tpu_torch.ops import bvh as bvh_mod
    from realtimepathtracingresearchframework_tpu_torch.ops import tlas
    from realtimepathtracingresearchframework_tpu_torch.ops import traverse_flat as tf
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_stream as ts,
    )
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_tlas as tt,
    )
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_tlas_stream as tts,
    )
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_v1 as tv,
    )

    v0, e1, e2 = _axis_terrain()
    fb = tf.pack_flat(bvh_mod.build_threaded_bvh(v0, e1, e2, leaf_size=leaf_size),
                      device)
    out = {"K1": fb, "K2": fb, "K3": fb}
    out["K4"] = out["K5"] = ts.pack_streamed(v0, e1, e2, device=device)
    meshes, ids = [(v0, e1, e2)], np.zeros(1, np.int32)
    xfs = np.concatenate([np.eye(3), np.zeros((3, 1))], 1)[None].astype(np.float32)
    blas = tlas.build_blas_set(meshes)
    nodes, row = tlas.build_tlas_nodes(tlas.instance_world_aabbs(blas, ids, xfs))
    tables = tlas.build_instance_tables(blas, ids, np.zeros(1, np.int32), xfs)
    out["K6"] = tt.pack_two_level(tt.pack_blas(meshes, device), ids, blas.tri_base,
                                  nodes, row, tables["inst_inv"].numpy(),
                                  tables["inst_cull_scale"].numpy())
    st7 = tts.pack_tlas_stream_static(meshes, device=device)
    out["K7"] = (st7, tts.pack_tlas_stream_frame(st7, ids, xfs, blas.tri_base))
    tb128 = bvh_mod.build_threaded_bvh(v0, e1, e2, leaf_size=tv.LEAF)
    out["K8a"] = tv.pack_v1(tb128, device)
    wide_max = tv.WIDE_MAX_ROWS
    tv.WIDE_MAX_ROWS = 0  # the field-major table, K8b's
    try:
        out["K8b"] = tv.pack_v1(tb128, device)
    finally:
        tv.WIDE_MAX_ROWS = wide_max
    check(out["K8a"].wide and not out["K8b"].wide, "v1 tables: wrong layouts")
    return out


def _axis_walk(name, st, o, d, tmax, any_hit):
    """One walk through its public wrapper (the kernel on CUDA tensors, the
    plain version on CPU ones): (t, source triangle) or blocked flags, on
    the host."""
    from realtimepathtracingresearchframework_tpu_torch.ops import traverse
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_binned as tb,
    )
    from realtimepathtracingresearchframework_tpu_torch.ops import traverse_flat as tf
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_resident as tr,
    )
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_stream as ts,
    )
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_tlas as tt,
    )
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_tlas_stream as tts,
    )
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_v1 as tv,
    )

    fns = {
        "K1": (tr.closest_hit_resident, tr.occluded_resident),
        "K2": (tf.closest_hit_flat, tf.occluded_flat),
        "K3": (tf.closest_hit_precull, tf.occluded_precull),
        "K4": (lambda *a: ts.closest_hit_streamed(*a, sort=True),
               ts.occluded_streamed),
        "K5": (tb.closest_hit_binned,
               lambda *a: tb.occluded_binned(*a, rounds=1)),
        "K6": (tt.closest_hit_tlas, tt.occluded_tlas),
        "K7": (lambda s, *a: tts.closest_hit_tlas_stream(*s, *a),
               lambda s, *a: tts.occluded_tlas_stream(*s, *a)),
        "K8a": (lambda *a: tv.closest_hit_v1(*a, map_tri=True), tv.occluded_v1),
    }
    fns["K8b"] = fns["K8a"]
    if any_hit:
        return fns[name][1](st, o, d, 0.0, tmax).cpu().numpy()
    h = fns[name][0](st, o, d, 0.0, tmax)
    if name in ("K1", "K2", "K3"):
        h = traverse.map_rows_to_tris(st, h)
    return h.t.cpu().numpy(), h.tri.cpu().numpy()


def phase_axis_queue(smi):
    """The axis-aligned queue of tests/test_torch_slab.py (1,024 rays with
    x = 0 directions from leaf-box faces of _axis_terrain's flat pack at
    leaf 32, 64 and 128) through every kernel on the card, closest and
    any-hit (segments just past the brute-force hit): each bitwise its
    plain version on the CPU (t bits, source triangles, flags), with the
    lanes where it differs from a brute-force Moller-Trumbore over every
    triangle counted and printed (its t not the least t, its triangle not
    one of those reaching it, or its flag not the brute force's). Returns
    {kernel: lanes off the brute force, summed over the leaf sizes}."""
    import torch

    from realtimepathtracingresearchframework_tpu_torch.ops import traverse

    rows = torch.from_numpy(np.concatenate(_axis_terrain(), axis=1))[None]
    off = {k: 0 for k in AXIS_WALKS}
    log(f"the axis-aligned queue through every kernel, {smi}:")
    for leaf in AXIS_LEAVES:
        cpu = _axis_structures(leaf, "cpu")
        card = _axis_structures(leaf, DEVICE)
        ro, rd = _axis_rays(cpu["K2"], np.random.default_rng(0x5EED))
        o, d = torch.from_numpy(ro), torch.from_numpy(rd)
        ok, _, _, tt = traverse._mt_rows(rows, *(x[:, None] for x in (
            o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2])))
        tt = torch.where(ok & (tt > 0.0) & (tt < 2.0e32), tt, 2.0e32)
        least = tt.amin(1)
        ties = ((tt == least[:, None]) & (least < 2.0e32)[:, None]).numpy()
        least = least.numpy()
        otm = np.where(least < 1e30, least * np.float32(1.001), 8.0).astype(np.float32)
        counts = {}
        for name in AXIS_WALKS:
            out = {}
            for dev, st in ((DEVICE, card[name]), ("cpu", cpu[name])):
                so, sd = _soa(ro, dev), _soa(rd, dev)
                t, tri = _axis_walk(name, st, so, sd, 2.0e32, False)
                flag = _axis_walk(name, st, so, sd,
                                  torch.from_numpy(otm).to(dev), True)
                out[dev] = (t, tri, flag)
            (t, tri, flag), (pt, ptri, pflag) = out[DEVICE], out["cpu"]
            mism = (int((t.view(np.int32) != pt.view(np.int32)).sum())
                    + int((tri != ptri).sum()) + int((flag != pflag).sum()))
            hit = least < 1e30
            good = (t.view(np.int32) == least.view(np.int32)) & np.where(
                hit, ties[np.arange(len(tri)), np.maximum(tri, 0)] & (tri >= 0),
                tri == -1) & (flag == hit)
            counts[name] = int((~good).sum())
            off[name] += counts[name]
            check(mism == 0, f"axis queue leaf {leaf}: {name} differs from its "
                  f"plain version on {mism} values")
        log(f"  leaf {leaf}: every kernel bitwise its plain version; lanes of "
            f"{len(ro)} off the brute force {counts}, {int((least < 1e30).sum())} "
            "lanes hit")
    return off


POST_FRAMES = 8  # frames of the image-domain path with a moving camera
POST_WINDOW = 8  # its spp_accumulation_window
POST_UPSCALE = 2  # its render_upscale_factor: a 3840x2160 display
POST_SMALL = (64, 36)  # the chain and the raster on the card against the CPU
POST_SMALL_DEPTH = 3
CHECKPOINT_SIZE = (480, 270)  # the checkpoint round trip, depth 3
# the LoD scene's mesh (tests/test_torch_lod.py): 4 triangles in LoD group 1
# and a coarse level of 1
LOD_FINE = np.array([[[-1, -1, 0], [0, -1, 0], [-0.5, 0, 0]],
                     [[0, -1, 0], [1, -1, 0], [0.5, 0, 0]],
                     [[-0.5, 0, 0], [0.5, 0, 0], [0, 1, 0]],
                     [[-0.5, 0, 0], [0, -1, 0], [0.5, 0, 0]]], np.float32)
LOD_COARSE = np.array([[[-1, -1, 0], [1, -1, 0], [0, 1, 0]]], np.float32)


def _post_config(cfg, upscale=POST_UPSCALE):
    """``cfg`` under REPROJECTION_MODE_ACCUMULATE (window POST_WINDOW) at
    ``upscale``, Reinhard-tonemapped so that the display lies in [0, 1]."""
    import dataclasses

    from realtimepathtracingresearchframework_tpu_torch.backend.params import (
        REPROJECTION_MODE_ACCUMULATE,
        TONEMAP_MODE_FAST,
    )

    return dataclasses.replace(cfg, params=cfg.params.replace(
        reprojection_mode=REPROJECTION_MODE_ACCUMULATE,
        spp_accumulation_window=POST_WINDOW, render_upscale_factor=upscale,
        early_tone_mapping_mode=TONEMAP_MODE_FAST))


def _moving(r, cfg, frames, readback=False):
    """``frames`` frames with the camera moving right 0.02 after each (a
    copy of cfg's camera); returns the frames' ms by CUDA events around
    ``render`` (each frame synchronised after its events) and the last
    display image."""
    import copy
    import dataclasses

    import torch

    cam = copy.deepcopy(cfg.camera)
    frame_ms, disp = [], None
    for _ in range(frames):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        r.render(dataclasses.replace(cfg, camera=cam))
        end.record()
        end.synchronize()
        frame_ms.append(start.elapsed_time(end))
        if readback:
            disp = r.readback_framebuffer()
        cam.move(right=0.02)
    return frame_ms, disp if readback else r.readback_framebuffer()


def _lod_renderer(device):
    """A renderer at POST_SMALL over the LoD scene (near camera: the base
    level)."""
    from realtimepathtracingresearchframework_tpu_torch.backend.renderer import (
        Renderer,
    )
    from realtimepathtracingresearchframework_tpu_torch.models import (
        procedural,
        vkr,
    )
    from realtimepathtracingresearchframework_tpu_torch.models.scene import Scene

    vs = procedural.identity_scene(
        [procedural.make_mesh("fine", LOD_FINE)],
        [vkr.VkrMaterial(name="m", base_color=np.ones(3, np.float32))])
    coarse = procedural.make_mesh("fine_lod1", LOD_COARSE)
    coarse.lod_group = vs.meshes[0].lod_group = 1
    vs.meshes.append(coarse)
    vs.lod_groups.append(vkr.VkrLodGroup(mesh_ids=[0, 1],
                                         detail_reduction=[0.0, 0.5]))
    r = Renderer(device=device)
    r.initialize(*POST_SMALL)
    r.set_scene(Scene.from_vkr_scene(vs))
    return r


def phase_postprocess(smi):
    """The image-domain frame path (ROADMAP item 20) and what hangs off it:
    cornell at MAIN_SIZE, depth 9, under REPROJECTION_MODE_ACCUMULATE
    (window POST_WINDOW), TAA and an upscale of 2, POST_FRAMES frames with
    the camera moving right 0.02 a frame through the port's Renderer: the
    frames' ms, K1 and no other kernel launched (its launches counted from
    0 just before the run and read just after), the 3840x2160 display
    finite, resolved in [0, 1] and after TAA within its variance clamp of
    that (Lanczos ringing takes TAA's history past 1, in the reference
    too), and the renderer's ``timers`` window for
    RENDERING, PROCESSING, TAA and READBACK (CUDA events read without a
    sync, READBACK on the host clock). The same chain at POST_SMALL, depth
    3, three frames, on the card against the CPU (``goldens.compare_card``);
    the raster G-buffer at MAIN_SIZE (ms by CUDA events) and at POST_SMALL
    on the card against the CPU (triangle ids, depth within 1e-5 relative);
    the LoD scene at POST_SMALL through K1 with the camera crossing a
    selection change (one rebuild), its ray queries equal to the CPU's; a
    checkpoint round trip on the card at CHECKPOINT_SIZE, depth 3 (save at
    frame 2, load into a fresh renderer, 2 more frames: bitwise 4
    uninterrupted frames, on the planar and the upscaled path). Returns
    K1's launches of the 1080p run."""
    import dataclasses

    import torch

    from realtimepathtracingresearchframework_tpu_torch import goldens
    from realtimepathtracingresearchframework_tpu_torch.backend.params import (
        RenderParams,
    )
    from realtimepathtracingresearchframework_tpu_torch.backend.renderer import (
        FrameConfig,
        Renderer,
    )
    from realtimepathtracingresearchframework_tpu_torch.models.camera import (
        OrientedCamera,
    )
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        resolve as resolve_mod,
    )
    from realtimepathtracingresearchframework_tpu_torch.ops import taa as taa_mod
    from realtimepathtracingresearchframework_tpu_torch.profile_frame import (
        frame_setup,
    )
    from realtimepathtracingresearchframework_tpu_torch.utils.profiling import (
        ProfilingMarker,
    )

    t_phase = time.perf_counter()
    r, cfg = frame_setup("cornell", DEVICE, MAIN_SIZE)
    r.options = r.options.replace(enable_taa=True)
    cfg = _post_config(cfg)
    counters = _counters()
    torch.cuda.synchronize()
    for reset, _ in counters.values():
        reset()
    frame_ms, disp = _moving(r, cfg, POST_FRAMES, readback=True)
    launches = {k: read() for k, (_, read) in counters.items()}
    _only("cornell reprojection + TAA x2", launches, ("K1",))
    width, height = MAIN_SIZE
    shape = (height * POST_UPSCALE, width * POST_UPSCALE, 4)
    # the resolved display before TAA lies in [0, 1]; TAA's Lanczos history
    # can ring past 1, and its variance clamp bounds each pixel by
    # [0, max(mean + 3 stddev, pixel + stddev)] of the resolved display, or
    # leaves the resolved pixel (reprojected off screen), in the reference
    # too (ops/taa.py). The "stddev", 9/8 (rms - mean), can round an ulp
    # below 0 where the 3x3 neighbourhood is flat, so the bounds are taken
    # with the resolved pixel and 0 beside them
    pre = resolve_mod.resolve_framebuffer(
        r.accum, float(cfg.params.exposure),
        int(cfg.params.early_tone_mapping_mode), POST_UPSCALE)
    mean, stddev = taa_mod._neighborhood_stats(pre)
    high = torch.maximum(mean + 3.0 * stddev, pre + stddev).cpu().numpy()
    pre = pre.cpu().numpy()
    pre_ok = bool(np.isfinite(pre).all() and (pre >= 0).all()
                  and (pre <= 1).all())
    disp_ok = bool(np.isfinite(disp).all()
                   and (disp >= np.minimum(high, 0.0)).all()
                   and (disp <= np.maximum(high, pre)).all())
    over_1 = float((disp > 1).any(-1).mean())
    under_0 = int((disp < 0).sum())
    markers = (ProfilingMarker.RENDERING, ProfilingMarker.PROCESSING,
               ProfilingMarker.TAA, ProfilingMarker.READBACK)
    window = {m.value: [round(x, 3) for x in r.timers.window_stats(m)]
              for m in markers}
    log(f"cornell {width}x{height} depth {cfg.params.max_path_depth} "
        f"ACCUMULATE (window {POST_WINDOW}) + TAA + upscale {POST_UPSCALE}, "
        f"{POST_FRAMES} frames, camera moving: frame ms "
        f"{[round(x, 3) for x in frame_ms]}, median of frames 2-"
        f"{POST_FRAMES} {float(np.median(frame_ms[1:])):.3f} ms by the "
        f"script's CUDA events; launches {launches}; resolved display "
        f"before TAA finite and in [0, 1] {pre_ok}; display {disp.shape} "
        f"finite and within TAA's clamp {disp_ok}, mean "
        f"{float(disp[..., :3].mean()):.5f}, max "
        f"{float(disp.max()):.6f}, share of pixels over 1 {over_1:.6f}, "
        f"channels below 0 {under_0} (min {float(disp.min()):.3e}); timers "
        f"window (avg, min, max, stddev) ms {window} ({smi})")
    check(disp.shape == shape, f"reprojection display shape {disp.shape}")
    check(pre_ok, "reprojection: resolved display not finite and in [0, 1]")
    check(disp_ok, "reprojection display not finite and within TAA's clamp")
    check(all(window[m.value][1] > 0 for m in markers),
          f"a timer marker was not fed: {window}")
    # the raster G-buffer at MAIN_SIZE on the card
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    gb = r.render_raster_gbuffer(cfg)
    end.record()
    end.synchronize()
    raster_ms = start.elapsed_time(end)
    raster_ms2 = cuda_ms(lambda: r.render_raster_gbuffer(cfg), 3)
    covered = float((gb.tri >= 0).float().mean())
    log(f"raster G-buffer {width}x{height} ({r._flat.num_tris} tris): "
        f"{raster_ms:.3f} ms first, {raster_ms2:.3f} ms warm (CUDA events), "
        f"{covered:.4f} of pixels covered")
    check(gb.tri.shape == (height, width) and covered > 0.5,
          f"raster G-buffer {tuple(gb.tri.shape)} covers {covered}")
    del r, gb

    # the chain and the raster at POST_SMALL on the card against the CPU
    small, rasters = {}, {}
    for device in (DEVICE, "cpu"):
        rr, cc = frame_setup("cornell", device, POST_SMALL,
                             depth=POST_SMALL_DEPTH)
        rr.options = rr.options.replace(enable_taa=True)
        cc = _post_config(cc)
        small[device] = (_moving(rr, cc, 3)[1], rr.readback_accumulation())
        g = rr.render_raster_gbuffer(cc)
        rasters[device] = (g.tri.cpu().numpy(), g.depth.cpu().numpy())
    res = goldens.compare_card(small[DEVICE][0][..., :3], small["cpu"][0][..., :3])
    res_acc = goldens.compare_card(small[DEVICE][1][..., :3],
                                   small["cpu"][1][..., :3])
    tri_differ = int((rasters[DEVICE][0] != rasters["cpu"][0]).sum())
    same = (rasters[DEVICE][0] == rasters["cpu"][0]) & (rasters["cpu"][0] >= 0)
    depth_rel = float((np.abs(rasters[DEVICE][1][same] - rasters["cpu"][1][same])
                       / rasters["cpu"][1][same]).max(initial=0.0))
    log(f"reprojection + TAA x2 at {POST_SMALL} depth {POST_SMALL_DEPTH}, 3 "
        f"frames, card against CPU: display {res}, accumulation {res_acc}; "
        f"raster G-buffer: {tri_differ} pixels of another triangle, depth "
        f"max relative error {depth_rel:.3e}")
    check(res["ok"] and res_acc["ok"], "reprojection chain: card against CPU")
    check(tri_differ == 0 and depth_rel <= 1e-5,
          f"raster G-buffer: {tri_differ} triangles, depth {depth_rel}")

    # LoD: the camera crosses a selection change
    lod = {}
    near = OrientedCamera.look_at([0, 0, 3.0], [0, 0, 0], fovy=50)
    far = OrientedCamera.look_at([0, 0, 4e4], [0, 0, 0], fovy=50)
    xs = np.linspace(-1.2, 1.2, 64, dtype=np.float32)
    o = np.stack([np.repeat(xs, 64), np.tile(xs, 64),
                  np.full(64 * 64, 5.0, np.float32)], -1)
    d = np.tile(np.array([[0, 0, -1.0]], np.float32), (64 * 64, 1))
    lod_launches = None
    for device in (DEVICE, "cpu"):
        lr = _lod_renderer(device)
        if device == DEVICE:
            for reset, _ in counters.values():
                reset()
        tris = []
        for cam in (near, near, far, far):
            lr.render(FrameConfig(camera=cam, params=RenderParams(
                max_path_depth=2)))
            tris.append(lr._flat.num_tris)
        if device == DEVICE:
            torch.cuda.synchronize()
            lod_launches = {k: read() for k, (_, read) in counters.items()}
        lod[device] = (lr.lod_rebuilds, tris, lr.render_ray_queries(o, d))
    rebuilds, tris, (t, tri, u, v) = lod[DEVICE]
    _, _, (t_c, tri_c, u_c, v_c) = lod["cpu"]
    hits_equal = bool((tri == tri_c).all() and _bitwise(
        torch.from_numpy(t), torch.from_numpy(t_c))[0] == 0)
    log(f"LoD scene at {POST_SMALL}: flattened tris per frame {tris}, "
        f"{rebuilds} rebuild(s), launches {lod_launches}; ray queries "
        f"{int((tri >= 0).sum())} hits of {len(tri)}, equal to the CPU's "
        f"(triangles, t bitwise) {hits_equal}")
    check(rebuilds == 1 and tris == [4, 4, 1, 1] and lod[DEVICE][0:2]
          == lod["cpu"][0:2], f"LoD rebuilds {lod}")
    _only("LoD scene", lod_launches, ("K1",))
    check(hits_equal, "LoD ray queries: card against CPU")

    # a checkpoint round trip on the card
    path = os.path.join(REPO, "build", "kernels", "chip_smoke_state.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    trips = {}
    for upscale in (1, 2):
        base, cc = frame_setup("cornell", DEVICE, CHECKPOINT_SIZE, depth=3)
        cc = dataclasses.replace(cc, params=cc.params.replace(
            render_upscale_factor=upscale))
        whole = base
        for _ in range(4):
            whole.render(cc)
        first, _ = frame_setup("cornell", DEVICE, CHECKPOINT_SIZE, depth=3)
        for _ in range(2):
            first.render(cc)
        first.save_state(path)
        resumed = Renderer(device=DEVICE)
        resumed.set_scene(first.scene, first._scene_config)
        resumed.load_state(path)
        for _ in range(2):
            resumed.render(cc)
        trips[upscale] = (
            resumed.readback_accumulation().tobytes()
            == whole.readback_accumulation().tobytes()
            and resumed.readback_framebuffer().tobytes()
            == whole.readback_framebuffer().tobytes()
            and resumed.frame_id == whole.frame_id == 4)
    os.remove(path)
    log(f"checkpoint round trip at {CHECKPOINT_SIZE} depth 3 (save at frame "
        f"2, load, 2 frames) bitwise 4 uninterrupted frames, by upscale: "
        f"{trips}; phase in {time.perf_counter() - t_phase:.1f} s")
    check(all(trips.values()), f"checkpoint round trip: {trips}")
    return launches


# the reference's profiling CSV columns: app/benchmark.py's five, then the
# profiling-tools extension's 32-frame window of each marker
# (extensions.py::ProfilingToolsExtension.csv_header)
PROFILING_COLUMNS = [
    "frames_total", "keyframe", "frames_accumulated", "render_time_ms",
    "app_time_ms"] + [
    f"{m}_{s}_ms" for m in ("buildblas", "buildtlas", "rendering",
                            "processing", "taa", "readback")
    for s in ("avg", "min", "max", "stddev")]
APP_PROFILING_FRAMES = 8
APP_SMALL = (64, 36)  # the card-against-CPU validation run
CAPTURE_KINDS = ("albedo_roughness", "motion_jitter", "normal_depth", "rgba")


def _counted(fn):
    """fn() with every kernel's launch count set to 0 just before it;
    returns (its result, the counts just after)."""
    import torch

    counters = _counters()
    torch.cuda.synchronize()
    for reset, _ in counters.values():
        reset()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: read() for k, (_, read) in counters.items()}


def _check_profiling_csv(path):
    """The CSV has the reference's columns and one row per frame; each
    row's render time is positive, and the rendering window's min, max and
    mean after row k (the profiling-tools columns, read from the frames'
    own CUDA events) are those of the render times of rows 1..k, so each
    row's time is its own frame's (``sync_interval`` 1). Returns the
    render times."""
    with open(path) as f:
        rows = [line.split(", ") for line in f.read().splitlines()]
    check(rows[0] == PROFILING_COLUMNS, f"profiling CSV header {rows[0]}")
    check(len(rows) == APP_PROFILING_FRAMES + 1,
          f"profiling CSV has {len(rows) - 1} rows")
    col = {name: i for i, name in enumerate(rows[0])}
    times = [float(r[col["render_time_ms"]]) for r in rows[1:]]
    check(all(t > 0.0 for t in times), f"profiling render times {times}")
    for k, row in enumerate(rows[1:], start=1):
        seen = times[:k]
        check(float(row[col["rendering_min_ms"]]) == min(seen)
              and float(row[col["rendering_max_ms"]]) == max(seen)
              and abs(float(row[col["rendering_avg_ms"]])
                      - sum(seen) / k) <= 1e-4,
              f"profiling row {k}: the rendering window {row[13:17]} is not "
              f"that of the rows' render times {seen}")
    return times


def _viewer_run(cli, argv, tmp):
    """The interactive viewer the CLI starts, on a thread: the CLI's
    renderer and state (``cli.setup``), ``warmup_async`` ahead of it,
    ``InteractiveViewer(port=0, watch_rebuild=False)`` with its ini in
    ``tmp``. Reads one /frame (a PNG of the frame size), posts one /input
    key until the camera moves, and /quit. Returns the walls (s): to the
    first served frame, to the camera's move."""
    import threading
    import urllib.error
    import urllib.request

    from realtimepathtracingresearchframework_tpu_torch.app.viewer import (
        InteractiveViewer,
    )

    r, ims, bundle, config = cli.setup(cli.build_parser().parse_args(argv))
    t0 = time.perf_counter()
    r.warmup_async(config.params)
    viewer = InteractiveViewer(r, bundle, ims, port=0, watch_rebuild=False,
                               app_ini=os.path.join(tmp, "app.ini"))
    url = f"http://127.0.0.1:{viewer.port}"
    result = {}

    def run():
        try:
            result["frames"] = viewer.run()
        except Exception as e:  # reported below
            result["error"] = e

    def post(path, body=b"{}"):
        req = urllib.request.Request(url + path, data=body, method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.read()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    walls = {}
    try:
        png = b""
        while not png.startswith(b"\x89PNG") and thread.is_alive():
            check(time.perf_counter() - t0 < 300, "viewer: no frame in 300 s")
            with urllib.request.urlopen(url + "/frame", timeout=60) as resp:
                png = resp.read()
            time.sleep(0.05)
        walls["first frame"] = time.perf_counter() - t0
        check(png.startswith(b"\x89PNG"), f"viewer ended: {result}")
        size = (int.from_bytes(png[16:20], "big"),
                int.from_bytes(png[20:24], "big"))
        check(size == (r.fb_width, r.fb_height), f"viewer frame {size}")
        pos0 = np.array(bundle.scene.camera.position, np.float64)
        t1 = time.perf_counter()
        post("/input", json.dumps({"keys": ["w"], "drag": [0, 0, 0],
                                   "wheel": 0}).encode())
        while np.allclose(bundle.scene.camera.position, pos0):
            check(time.perf_counter() - t1 < 120 and thread.is_alive(),
                  f"viewer: the camera did not move ({result})")
            time.sleep(0.05)
        walls["camera moved"] = time.perf_counter() - t1
        post("/input", json.dumps({"keys": [], "drag": [0, 0, 0],
                                   "wheel": 0}).encode())
    finally:
        try:
            post("/quit")
        except urllib.error.URLError:
            pass  # the server is already down; the join below reports why
        thread.join(timeout=120)
    check(not thread.is_alive(), "viewer thread did not end after /quit")
    check("error" not in result, f"viewer failed: {result.get('error')!r}")
    check(os.path.exists(os.path.join(tmp, "app.ini")), "viewer: no ini saved")
    walls["frames"] = result["frames"]
    return walls


def phase_app(smi):
    """The app shell on the card (ROADMAP item 21, slice F2), cornell at
    MAIN_SIZE, the CLI's defaults (depth 9, binned RIS light sampling), in
    a temporary directory: ``python -m ...app.cli cornell --disable-ui
    --png`` as a subprocess (exit 0, a finite PNG of the frame size); in
    process through ``cli.main``: ``--disable-ui``, ``--validation`` at 4
    spp, ``--profiling`` over APP_PROFILING_FRAMES frames (the reference's
    columns, one row per frame, each row's render time its own frame's:
    ``_check_profiling_csv``) and ``--data-capture`` at 2 spp with 2
    POI-derived viewpoints (every file the reference names, finite); the
    interactive viewer (``_viewer_run``); each with its launch counts set
    to 0 just before and read just after: K1 and no other. Then the
    warm-up: four fresh renderers from ``cli.setup`` (the kernels built and
    loaded), without, with, with and without a joined ``warmup_async``,
    their first frames' walls and bitwise-equal images; and ``--validation``
    at APP_SMALL, 4 spp, on the card against ``--backend cpu``
    (``goldens.compare_card``). Every wall is printed with the card.
    Returns K1's launches by mode."""
    import tempfile

    import torch

    from realtimepathtracingresearchframework_tpu_torch import goldens
    from realtimepathtracingresearchframework_tpu_torch.app import cli
    from realtimepathtracingresearchframework_tpu_torch.utils import image_io

    t_phase = time.perf_counter()
    walls, launches = {}, {}
    width, height = MAIN_SIZE
    img = ["--img", str(width), str(height)]
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="rptr_app_") as tmp:
        def png(name):
            px = image_io.read_png(os.path.join(tmp, name))
            check(px.shape[:2] == (height, width), f"{name}: {px.shape}")
            x = px.astype(np.float32) / 255.0
            check(np.isfinite(x).all() and x.min() >= 0 and x.max() <= 1
                  and x[..., :3].mean() > 0, f"{name}: empty or out of [0, 1]")
            return float(x[..., :3].mean())

        def run_cli(label, argv):
            os.chdir(tmp)
            t0 = time.perf_counter()
            try:
                rc, counts = _counted(lambda: cli.main(["cornell", *argv]))
            finally:
                walls[label] = time.perf_counter() - t0
                os.chdir(cwd)
            check(rc == 0, f"app {label}: exit {rc}")
            _only(f"app {label}", counts, ("K1",))
            launches[label] = counts["K1"]

        t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
        proc = subprocess.run(
            [sys.executable, "-m", f"{PKG}.app.cli", "cornell",
             "--disable-ui", "--png"],
            cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
        walls["entry point (process)"] = time.perf_counter() - t0
        check(proc.returncode == 0, f"app entry point exit {proc.returncode}:"
              f"\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        means = {"entry point": png("out.png")}
        run_cli("disable-ui", [*img, "--disable-ui", "--png"])
        means["disable-ui"] = png("out.png")
        run_cli("validation", [*img, "--validation", "v", "--validation-spp", "4",
                            "--png"])
        means["validation"] = png("v_0004.png")
        run_cli("profiling", [*img, "--profiling", "p", "--profiling-frames",
                           str(APP_PROFILING_FRAMES)])
        times = _check_profiling_csv(os.path.join(tmp, "p.csv"))
        run_cli("data capture", [*img, "--data-capture", "d",
                              "--data-capture-spp", "2",
                              "--data-capture-viewpoints", "2"])
        names = sorted(f"d_{k}_{a}.exr" for k in ("0000", "0001", "vp00", "vp01")
                       for a in CAPTURE_KINDS)
        got = sorted(n for n in os.listdir(tmp) if n.startswith("d_"))
        check(got == names, f"data capture wrote {got}")
        for name in names:
            x = image_io.read_exr_rgba(os.path.join(tmp, name))
            check(x.shape == (height, width, 4) and np.isfinite(x).all(),
                  f"{name}: shape {x.shape}, not finite")
        viewer, counts = _counted(lambda: _viewer_run(
            cli, ["cornell", *img], tmp))
        _only("app viewer", counts, ("K1",))
        launches["viewer"] = counts["K1"]

        # the warm-up's first-frame saving, kernels already built and loaded
        args = cli.build_parser().parse_args(["cornell", *img])
        first, warm_s, images = [], [], []
        for warm in (False, True, True, False):
            r, _, _, config = cli.setup(args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if warm:
                r.warmup_async(config.params).join()
                torch.cuda.synchronize()
                warm_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            r.render(config)
            torch.cuda.synchronize()
            first.append(time.perf_counter() - t0)
            images.append(r.readback_accumulation())
            del r
        same = all(x.tobytes() == images[0].tobytes() for x in images)
        check(same, "a frame after warmup_async differs from one without")

        # card against CPU at APP_SMALL
        small = ["--img", str(APP_SMALL[0]), str(APP_SMALL[1]),
                 "--validation-spp", "4"]
        run_cli("small validation", [*small, "--validation", "card"])
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            check(cli.main(["cornell", *small, "--validation", "cpu",
                            "--backend", "cpu"]) == 0, "CPU validation")
            walls["small validation, CPU"] = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        card_cpu = goldens.compare_card(
            image_io.read_pfm(os.path.join(tmp, "card_0004.pfm")),
            image_io.read_pfm(os.path.join(tmp, "cpu_0004.pfm")))
        check(card_cpu["ok"], f"app validation card against CPU: {card_cpu}")
    walls = {k: round(v, 3) for k, v in walls.items()}
    log(f"app phase on {smi}: walls s {walls}; images' means {means}; "
        f"profiling render ms {times}; viewer {viewer}; K1 launches {launches}")
    log(f"app warm-up on {smi}: first-frame walls s without, with, with, "
        f"without a joined warmup_async {[round(x, 4) for x in first]}, the "
        f"warm-ups {[round(x, 4) for x in warm_s]} s, frames bitwise equal "
        f"{same}; card against CPU at {APP_SMALL}, 4 spp: {card_cpu}; phase in "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


MULTI_FRAMES = 2  # timed frames of the multi-device cornell and village paths
SHARD_SIZE = MAIN_SIZE  # the sharded render: two 540-row bands at 1080p


def _multi_devices():
    """The devices of phase 22: min(max(2, cards), 4) of them, distinct
    cards where there are that many, else cuda:0 repeated."""
    import torch

    count = torch.cuda.device_count()
    n = min(max(2, count), 4)
    if count >= n:
        return [f"cuda:{i}" for i in range(n)], count
    return ["cuda:0"] * n, count


def _sync_all():
    """Wait for every card's work (``torch.cuda.synchronize()`` waits for
    the current device only)."""
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


@contextlib.contextmanager
def _per_device_launches():
    """Tally K1, K2, K3 and K7 launches by the device they run on, through
    their counted launch functions (each wrapper checks that every operand
    lies on that device). Yields {(kernel, device): launches}."""
    from realtimepathtracingresearchframework_tpu_torch.ops import traverse_flat as tf
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_resident as tr,
    )
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_tlas_stream as tts,
    )

    tally = {}
    k1, flat, k7 = tr._launch, tf._launch, tts.launch

    def note(kernel, dev):
        key = (kernel, str(dev))
        tally[key] = tally.get(key, 0) + 1

    def k1_launch(bvh, comps, *a, **kw):
        note("K1", comps[0].device)
        return k1(bvh, comps, *a, **kw)

    def flat_launch(name, bvh, rays, *a, **kw):
        note("K2" if name == tf.K2 else "K3", rays.device)
        return flat(name, bvh, rays, *a, **kw)

    def k7_launch(static, fr, rays, *a, **kw):
        note("K7", rays.device)
        return k7(static, fr, rays, *a, **kw)

    tr._launch, tf._launch, tts.launch = k1_launch, flat_launch, k7_launch
    try:
        yield tally
    finally:
        tr._launch, tf._launch, tts.launch = k1, flat, k7


def _multi_frames(r, cfg, frames, animate=False):
    """A warm-up frame, then ``frames`` frames, each timed by the host clock
    to the end of every card's work, with a TLAS update before each under
    ``animate`` (frame (f + 1) % 16, frame 0 before the warm-up, as
    ``_timed_frames``). Every count is set to 0 just before the frames and
    read just after. Returns (launches, per-device launches, frame walls
    ms, the last frame's accumulation, its rays)."""
    counters = _counters()
    if animate:
        r.set_animation_frame(0)
    r.render(cfg)
    _sync_all()
    for reset, _ in counters.values():
        reset()
    walls, images = [], []
    with _per_device_launches() as tally:
        for f in range(frames):
            t0 = time.perf_counter()
            if animate:
                r.set_animation_frame((f + 1) % ANIM_FRAMES)
            r.render(cfg)
            _sync_all()
            walls.append((time.perf_counter() - t0) * 1e3)
            if animate:
                images.append(r.readback_accumulation())
    launches = {k: read() for k, (_, read) in counters.items()}
    images.append(r.readback_accumulation())
    return launches, dict(tally), walls, images, r.last_frame_rays()


def _replicas_on_their_devices(label, r):
    """Every tensor leaf of each replica lies on its device, and chunk c's
    accumulators on devices[c % n]."""
    import torch

    def leaves(tree, out):
        if isinstance(tree, torch.Tensor):
            out.append(tree)
        elif isinstance(tree, (tuple, list)):
            for v in tree:
                leaves(v, out)
        return out

    for ds, dev in zip(r._device_scenes, r.devices):
        bad = [t.device for t in leaves(ds, []) if t.device != dev]
        check(not bad, f"{label}: replica on {dev} holds tensors on {set(bad)}")
    n = len(r.devices)
    for c, acc in enumerate(r._acc_chunks):
        check(all(a.device == r.devices[c % n] for a in acc),
              f"{label}: chunk {c} not on {r.devices[c % n]}")


def _on_every_device(label, tally, kernels, devices):
    """On distinct cards, each of ``kernels`` launched on every one of
    ``devices`` (the per-device tally of ``_per_device_launches``); with
    cuda:0 repeated there is one device to see."""
    for k in kernels:
        for dev in sorted(set(devices)):
            check(tally.get((k, dev), 0) > 0,
                  f"{label}: no {k} launch on {dev}, tally {tally}")


def _multi_pair(label, scene, devices, kernels, frames, size, depth=9,
                single_env=None, animate=False, **kw):
    """One path on a single-device renderer and on a renderer over
    ``devices``, in the same process: walls, launches (each run's
    counts), the per-device tally, and every compared frame bitwise.
    Returns the multi-device run's launches."""
    from realtimepathtracingresearchframework_tpu_torch.profile_frame import (
        frame_setup,
    )

    runs = {}
    for tag, devs in (("single", None), ("multi", devices)):
        with env(**((single_env or {}) if devs is None else {})):
            t0 = time.perf_counter()
            r, cfg = frame_setup(scene, DEVICE, size, depth, devices=devs, **kw)
            setup_s = time.perf_counter() - t0
            runs[tag] = (r, *_multi_frames(r, cfg, frames, animate), setup_s)
            check(r._wavefront is None, f"{label} {tag}: the wavefront executor "
                  "ran (the monolith is compared)")
    (r1, l1, _, w1, im1, rays1, s1), (rm, lm, tally, wm, imm, raysm, sm) = (
        runs["single"], runs["multi"])
    check(rm._multi and len(rm._device_scenes) == len(devices),
          f"{label}: not a {len(devices)}-device renderer")
    _replicas_on_their_devices(label, rm)
    _only(f"{label} multi-device", lm, kernels)
    _only(f"{label} single-device", l1, kernels)
    check(lm == l1, f"{label}: launches {lm} against the single device's {l1}")
    same = all(np.array_equal(a, b) for a, b in zip(im1, imm))
    check(same and len(im1) == len(imm), f"{label}: multi-device frames differ "
          "from the single device's")
    check(rays1 == raysm, f"{label}: rays {raysm} against {rays1}")
    stats = rm.stats()
    log(f"phase 22 {label} {size[0]}x{size[1]} depth {depth} on {len(devices)} "
        f"devices ({', '.join(devices)}): frame walls ms "
        f"{[round(x, 3) for x in wm]} (median {float(np.median(wm)):.3f}) "
        f"beside the single device's {[round(x, 3) for x in w1]} (median "
        f"{float(np.median(w1)):.3f}), set-up {sm:.2f} s beside {s1:.2f} s, "
        f"Renderer.stats().render_time {stats.render_time:.3f} ms (host clock "
        f"over the sync_interval window), launches {lm} over {frames} frames "
        f"(per frame { {k: n / frames for k, n in lm.items() if n} }), by "
        f"device {tally}, "
        f"{raysm} rays in the last frame, {len(imm)} frames bitwise the single "
        f"device's")
    return lm, tally, float(np.median(wm)), float(np.median(w1))


def phase_multi_device(smi):
    """Phase 22: the multi-device paths on min(max(2, cards), 4) devices
    (distinct cards where there are that many, else cuda:0 repeated), each
    bitwise the single-device frames in the same process, beside their
    walls: cornell at MAIN_SIZE depth 9 (K1), the village at MAIN_SIZE
    depth 9 through the monolith (RPTR_HOST_WAVEFRONT=0 on the single
    renderer; K2, K3), the instanced600 bench row (512x384, depth 3, 8
    animated frames, K7; one swizzle chunk, so the first device only) and
    instanced600 at MAIN_SIZE (depth 3, 2 animated frames, K7 over 4
    chunks, so every device's refreshed replica); ``build_sharded_render``
    at 1080p over two 540-row bands against ``render_tile`` of the whole
    frame; ``dryrun_multichip(4)``; the CLI with ``--devices 1``, with
    ``--devices`` the number of cards where there are 2 or more (the same
    image), and with more devices than cards (the reference's error). On
    distinct cards every kernel of a multi-chunk path must launch on every
    card. Returns each kernel's launches on these paths."""
    import tempfile

    import torch

    from realtimepathtracingresearchframework_tpu_torch.app import cli
    from realtimepathtracingresearchframework_tpu_torch.ops import integrator as I
    from realtimepathtracingresearchframework_tpu_torch.parallel import dryrun
    from realtimepathtracingresearchframework_tpu_torch.parallel.render_sharded import (
        build_sharded_render,
    )
    from realtimepathtracingresearchframework_tpu_torch.profile_frame import (
        frame_setup,
    )
    from realtimepathtracingresearchframework_tpu_torch.utils.error_io import (
        RenderError,
    )

    t_phase = time.perf_counter()
    devices, count = _multi_devices()
    log(f"phase 22: {count} card(s) ({smi}); multi-device paths on "
        f"{len(devices)} devices: {devices} "
        f"({'distinct cards' if len(set(devices)) == len(devices) else 'cuda:0 repeated'})")
    paths = {"K1": {}, "K2": {}, "K3": {}, "K7": {}}
    launches, tally, *_ = _multi_pair("cornell", "cornell", devices, ("K1",),
                                      MULTI_FRAMES, MAIN_SIZE)
    check(launches["K1"] == 68 * MULTI_FRAMES,
          f"cornell multi-device: {launches['K1']} K1 launches in "
          f"{MULTI_FRAMES} frames, not 68 a frame")
    _on_every_device("cornell", tally, ("K1",), devices)
    paths["K1"]["multi-device cornell 1080p"] = launches["K1"]
    launches, tally, *_ = _multi_pair(
        "village monolith", "village", devices, ("K2", "K3"), 1, MAIN_SIZE,
        single_env={"RPTR_HOST_WAVEFRONT": "0"})
    # K2 on every card; K3 not on cuda:0 of four: chunk 0, the top rows, is
    # sky after bounce 0
    _on_every_device("village monolith", tally, ("K2",), devices)
    for k in ("K2", "K3"):
        paths[k]["multi-device village 1080p monolith"] = launches[k]
    label, num_inst, size, depth, frames, _ = TLAS_PATHS[0]
    launches, *_ = _multi_pair(label, "instanced", devices, ("K7",), frames,
                               size, depth, animate=True, num_inst=num_inst)
    paths["K7"][f"multi-device {label} (one chunk: first device only)"] = (
        launches["K7"])
    label, num_inst, size, *_ = TLAS_PATHS[1]
    launches, tally, *_ = _multi_pair(
        f"{label} animated", "instanced", devices, ("K7",), MULTI_FRAMES,
        size, 3, animate=True, num_inst=num_inst)
    _on_every_device(f"{label} animated", tally, ("K7",), devices)
    paths["K7"][f"multi-device {label} depth 3 animated"] = launches["K7"]

    # the row-band sharded render: two 540-row bands
    bands = devices[:2]
    r, cfg = frame_setup("cornell", DEVICE, SHARD_SIZE)
    w, h = SHARD_SIZE
    icfg = r._integrator_config(cfg.params)
    view = r._view(cfg.camera)
    fp = I.FrameParams()
    f = build_sharded_render(bands, icfg, w, h)
    counters = _counters()
    walls = {}
    for tag, fn in (("single", lambda: I.render_tile(r.device_scene, icfg, fp,
                                                      view, w, h, 1)),
                    ("sharded", lambda: f(r.device_scene, fp, view, 1)),
                    ("single ", lambda: I.render_tile(r.device_scene, icfg, fp,
                                                       view, w, h, 1)),
                    ("sharded ", lambda: f(r.device_scene, fp, view, 1))):
        _sync_all()
        for reset, _ in counters.values():
            reset()
        t0 = time.perf_counter()
        img, rays = fn()
        _sync_all()
        walls[tag] = ((time.perf_counter() - t0) * 1e3, img, int(rays),
                      {k: read() for k, (_, read) in counters.items()})
    single, sharded = walls["single "], walls["sharded "]
    check(sharded[1].shape == (h, w, 4) and sharded[1].device == torch.device(
        bands[0]), f"sharded 1080p: {sharded[1].shape} on {sharded[1].device}")
    check(torch.equal(single[1], sharded[1]) and single[2] == sharded[2],
          "sharded 1080p is not bitwise the single-device frame")
    _only("sharded 1080p", sharded[3], ("K1",))
    check(sharded[3] == single[3], f"sharded 1080p launches {sharded[3]} "
          f"against {single[3]}")
    paths["K1"]["sharded 1080p (2 bands)"] = sharded[3]["K1"]
    log(f"phase 22 sharded {w}x{h} over {bands} (540-row bands), 1 spp depth "
        f"9: walls ms {walls['sharded'][0]:.3f}, {sharded[0]:.3f} beside "
        f"render_tile of the whole frame {walls['single'][0]:.3f}, "
        f"{single[0]:.3f}; {sharded[2]} rays, launches {sharded[3]}, bitwise "
        f"the single-device frame")
    del r, walls, single, sharded

    t0 = time.perf_counter()
    out, launches = _counted(lambda: dryrun.dryrun_multichip(4))
    paths["K1"]["dryrun_multichip(4)"] = launches["K1"]
    check(out["rays"] > 0 and out["rays2"] > 0 and launches["K1"] > 0,
          f"dryrun_multichip(4): {out['rays']}, {out['rays2']} rays, {launches}")
    log(f"phase 22 dryrun_multichip(4): {(time.perf_counter() - t0):.2f} s, "
        f"launches {launches}")

    cwd = os.getcwd()
    n_cards = len(set(devices)) if len(set(devices)) > 1 else 1
    cli_runs = {}
    with tempfile.TemporaryDirectory(prefix="rptr_multi_") as tmp:
        try:
            for n in sorted({1, n_cards}):
                os.makedirs(os.path.join(tmp, str(n)))
                os.chdir(os.path.join(tmp, str(n)))
                t0 = time.perf_counter()
                with _per_device_launches() as tally:
                    rc, launches = _counted(lambda: cli.main(
                        ["cornell", "--img", str(MAIN_SIZE[0]),
                         str(MAIN_SIZE[1]), "--devices", str(n),
                         "--disable-ui"]))
                wall = time.perf_counter() - t0
                check(rc == 0 and os.listdir(".") == ["out.exr"],
                      f"cli --devices {n}: rc {rc}, files {os.listdir('.')}")
                _only(f"cli --devices {n}", launches, ("K1",))
                if n > 1:
                    _on_every_device(f"cli --devices {n}", tally, ("K1",),
                                     [f"cuda:{i}" for i in range(n)])
                paths["K1"][f"cli --devices {n}"] = launches["K1"]
                with open("out.exr", "rb") as fh:
                    cli_runs[n] = (wall, launches, dict(tally), fh.read())
            check(cli_runs[n_cards][3] == cli_runs[1][3],
                  f"cli --devices {n_cards}: out.exr differs from --devices 1's")
            os.chdir(tmp)
            too_many = count + 1
            try:
                cli.main(["cornell", "--img", "64", "36", "--devices",
                          str(too_many), "--disable-ui"])
                raised = None
            except RenderError as e:
                raised = str(e)
            check(raised == f"--devices {too_many} but only {count} devices "
                  "available", f"cli --devices {too_many}: {raised!r}")
        finally:
            os.chdir(cwd)
    for n, (wall, launches, tally, _) in cli_runs.items():
        log(f"phase 22 cli --devices {n} at {MAIN_SIZE[0]}x{MAIN_SIZE[1]}: "
            f"{wall:.2f} s, launches {launches}, by device {tally}")
    log(f"phase 22 cli: out.exr of --devices {n_cards} the same bytes as "
        f"--devices 1's; --devices {too_many}: {raised!r}")
    log(f"phase 22 in {time.perf_counter() - t_phase:.1f} s; paths {paths}")
    return paths


def main():
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; needs one CUDA card")
        return 1
    if not os.path.isdir(os.path.join(REPO, PKG)):
        log(f"chip_smoke: {PKG}/ not found beside this script; run it from "
            "the root of a checkout")
        return 1
    sys.path.insert(0, REPO)
    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    k1_launches, mega, mega_cfg = phase_main_path()
    rng_launches = phase_rng_paths()
    village, village_ris, village_shade = phase_village_path()
    shade_rows = phase_fused_shade()
    village_compacted = phase_village_compacted(smi)
    _, k1_merged = phase_wavefront_path(mega)
    cornell_dof = phase_cornell_b3(mega, mega_cfg)
    del mega
    post_launches = phase_postprocess(smi)
    app_launches = phase_app(smi)
    terrain, terrain_merged = phase_terrain_path()
    stream, (r500, cfg500) = phase_stream_paths()
    strategies, (rq, cfgq) = phase_stream_strategies(r500, cfg500)
    tlas_paths = phase_tlas_paths()
    flat_anim = phase_flat_animation(smi)
    tlas_slice = phase_tlas_slice()
    v1_paths = phase_v1_paths()
    k6_ordered_launches = (
        tlas_slice["instanced500 1080p ordered"][3]["modes"]["K6 ordered"])
    tlas_k7_launches = tlas_paths["instanced600 1080p"][2]["K7"]
    tlas_k6_launches = tlas_paths["instanced500 1080p"][2]["K6"]
    k6_global_launches = (
        tlas_paths["instanced500 1080p"][3]["modes"]["K6 global"])
    k1 = dict(phase_parity(smi), launches=k1_launches)
    k1["merged"]["launches"] = k1_merged
    flat = phase_flat(smi)
    streamed = phase_streamed(r500, cfg500, smi)
    del r500
    rec4q, rec4q_ordered, rec5q, rec_multislot = phase_streamed_quantized(
        rq, cfgq, smi)
    del rq
    phase_goldens()
    phase_small_terrain()
    phase_small_streamed()
    tlas = phase_tlas(tlas_paths, smi)
    del tlas_paths
    past_cap = f"instanced{INST_PAST_CAP} 1080p"
    r2500, cfg2500, launches2500, rec2500 = tlas_slice[past_cap]
    k7_global = compare_k7_modes(past_cap, r2500, cfg2500, smi)
    del r2500, tlas_slice
    phase_small_instanced()
    phase_small_flat_animation()
    v1 = phase_v1_queues(v1_paths, smi)
    axis_off = phase_axis_queue(smi)
    v1["K8a"]["merged"]["launches"] = (
        v1_paths["v1 cornell PT_WAVEFRONT"][3]["merged"]["K8"])
    # no V1 path of this script runs the wavefront variant on a K8b scene
    v1["K8b"]["merged"]["launches"] = (
        v1_paths["v1 terrain200 1080p"][3]["merged"]["K8"])
    v1_launches = {label: p[2] for label, p in v1_paths.items()}
    del v1_paths
    phase_queries()
    multi_paths = phase_multi_device(smi)
    from realtimepathtracingresearchframework_tpu_torch.ops import traverse_flat as tf
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        traverse_tlas as tt,
    )

    main_stream, stream_merged, stream_shade = stream["terrain500 1080p"]
    # the merged launches of the runs the single-mode counts come from (no
    # route of the port, nor of the reference, reaches K2's and K4's merged
    # modes: only tests and this script's parity phases launch them)
    flat[tf.K2]["merged"]["launches"] = terrain_merged["K2"]
    streamed["traverse_streamed"]["merged"]["launches"] = stream_merged["K4"]
    # this slice's modes, each with the launches of the path that runs it
    quantized = strategies["quantized"]["launches"]
    streamed["traverse_streamed"]["quantized"] = dict(
        rec4q, launches=quantized["K4"])
    streamed["traverse_streamed"]["ordered"] = dict(
        streamed["traverse_streamed"]["ordered"],
        launches=strategies["ordered"]["modes"]["K4 ordered"])
    log(f"K4 ordered on int16 tiles (no path of this script): {rec4q_ordered}")
    rec5 = dict(streamed["traverse_binned"], quantized=dict(
        rec5q, launches=quantized["K5"]), multislot=dict(
        rec_multislot, launches=strategies["multislot"]["modes"]["multislot"]))
    # K6's TLAS read from global memory (the placement the launcher leaves
    # to larger TLASes) on the same primary chunk, with its launches there
    k6_shapes = tlas["K6"]["shapes"]
    k6 = dict(tlas["K6"], launches=tlas_k6_launches, ordered=dict(
        tlas["K6 ordered"], launches=k6_ordered_launches), **{"global": dict(
            ms=k6_shapes[False, tt.THREADS], staged_ms=k6_shapes[True, tt.THREADS],
            bound_ms=tlas["K6"]["bound_ms"], launches=k6_global_launches)})
    k7 = dict(tlas["K7"], launches=tlas_k7_launches, **{"global": dict(
        k7_global, launches=rec2500["modes"]["K7 global"])})
    log(f"RNG paths' launches {rng_launches}; village PT_WAVEFRONT compacted "
        f"launches {village_compacted}; flattened animation launches "
        f"{flat_anim}")
    # this slice's paths: each kernel's launches on the paths that put it
    # under a new pack or queue
    k1["paths"] = {f"rng {name}": n["K1"] for name, n in rng_launches.items()}
    k1["paths"]["cornell DoF"] = cornell_dof["K1"]
    k1["paths"]["cornell reprojection + TAA x2"] = post_launches["K1"]
    k1["paths"].update({f"app {mode}": n for mode, n in app_launches.items()})
    refit_row, rebuilt_row = (p[0] for p in FLAT_ANIM_PATHS)
    paths = {kern: {"village PT_WAVEFRONT compacted": village_compacted[kern],
                    rebuilt_row: flat_anim[rebuilt_row][kern],
                    "village RIS": village_ris[kern]}
             for kern in ("K2", "K3")}
    paths.update({kern: {refit_row: flat_anim[refit_row][kern]}
                  for kern in ("K4", "K5")})
    log(f"village path launches {village}; {past_cap} launches "
        f"{launches2500}; V1 path launches {v1_launches}")
    records = {
        "traverse_resident": k1,
        tf.K2: dict(flat[tf.K2], launches=terrain["K2"]),
        tf.K3: dict(flat[tf.K3], launches=terrain["K3"]),
        "traverse_streamed": dict(streamed["traverse_streamed"],
                                  launches=main_stream["K4"]),
        "traverse_binned": dict(rec5, launches=main_stream["K5"]),
        "traverse_tlas": k6,
        "traverse_tlas_stream": k7,
        "K8a": v1["K8a"],
        "K8b": v1["K8b"],
    }
    for name, kern in ((tf.K2, "K2"), (tf.K3, "K3"),
                       ("traverse_streamed", "K4"), ("traverse_binned", "K5")):
        records[name]["paths"] = paths[kern]
    # phase 22's multi-device paths
    records["traverse_tlas_stream"]["paths"] = {}
    for name, kern in (("traverse_resident", "K1"), (tf.K2, "K2"),
                       (tf.K3, "K3"), ("traverse_tlas_stream", "K7")):
        records[name]["paths"].update(multi_paths[kern])
    # each kernel's lanes off the brute force on the axis-aligned queue
    for name, kern in (("traverse_resident", "K1"), (tf.K2, "K2"),
                       (tf.K3, "K3"), ("traverse_streamed", "K4"),
                       ("traverse_binned", "K5"), ("traverse_tlas", "K6"),
                       ("traverse_tlas_stream", "K7"), ("K8a", "K8a"),
                       ("K8b", "K8b")):
        records[name]["axis_lanes_off_brute_force"] = axis_off[kern]
    # shade.cu's two kernels: their launches on the cells' main paths, the
    # times of 3f's village bounce 0 (the widest textured launch) and every
    # row of 3f under ``carries``
    for kern in SHADE_KERNELS:
        rows = [row for case_rows in shade_rows.values() for row in case_rows
                if row["kernel"] == kern]
        head = next(row for row in rows
                    if row["case"] == "village" and row["bounce"] == 0)
        records[kern] = {
            "launches": village_shade[kern] + stream_shade[kern],
            "max_abs_err": max((big for row in rows
                                for _, big in row["differ"].values()),
                               default=0.0),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": "bytes",
            "paths": {"village 1080p": village_shade[kern],
                      "terrain500 1080p": stream_shade[kern]},
            "carries": {f"{row['case']} bounce {row['bounce']}": {
                k: row[k] for k in ("lanes", "active", "ms", "plain_ms",
                                    "bytes", "bound_ms")} for row in rows},
        }
    # traverse_v1.cu and shade.cu hold two kernels each, with a record each
    sources = {name: sr for name, sr in KERNELS.items()
               if name not in ("traverse_v1", "shade")}
    sources.update({name: (KERNELS["traverse_v1"][0], replaces)
                    for name, replaces in V1_KERNELS.items()})
    sources.update({name: KERNELS["shade"] for name in SHADE_KERNELS})
    kernels = []
    for name, (source, replaces) in sources.items():
        rec = records[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": rec["launches"],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            # no single PyTorch call computes a BVH closest hit, nor a
            # bounce's shading
            "library_ms": None,
        })
        for extra in ("grazing_lanes", "wrapper_ms", "paths",
                      "axis_lanes_off_brute_force", "carries"):
            if extra in rec:
                kernels[-1][extra] = rec[extra]
        for mode in ("merged", "quantized", "ordered", "multislot", "global"):
            if mode in rec:
                m = rec[mode]
                kernels[-1][mode] = {
                    k: m[k] for k in ("launches", "ms", "wrapper_ms", "plain_ms",
                                      "separate_ms", "separate_kernel_ms",
                                      "k5_ms", "staged_ms", "bound_ms",
                                      "max_abs_err") if k in m}
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
