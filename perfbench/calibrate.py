"""The readings that the comparison's limit is set from, at a cell's own
size, in one process: the program's sound runs over many seeds, the
bfloat16 control (the reference in the program's place, its scene held in
bfloat16), and optionally the program with one of its own lower-precision
options switched on. Not run by the benchmark's runs.

    python3 -m perfbench.calibrate --workload village-1080p --frames 100 \
        --seeds 11,12,13 [--program] [--control] \
        [--program-option quantized_geometry]

For each seed, ``--program`` renders ``--frames`` frames from a fresh
accumulation with the seed's shot offset, as a run's window does, reads
the sampled pixels back and compares them with the reference's;
``--control`` compares the control's pixels with the reference's, on the
same pixels and frames.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from perfbench import check
from perfbench.cells import load_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--frames", type=int, required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--program-option", default=None,
                    help="a boolean RenderBackendOptions field to switch on")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from perfbench import scenes
    from perfbench.program import Program
    from perfbench.reference.render import Reference

    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    t, c = cell.traffic, cell.config
    w, h = int(t["width"]), int(t["height"])
    vs = scenes.build(c)
    prog = None
    if args.program:
        if args.program_option:
            t = dict(t, options={**t.get("options", {}), args.program_option: True})
        prog = Program(c, t, vs, device=args.device,
                       log=lambda *a: print(*a, file=sys.stderr))
        prog.load_kernels()
        prog.warm(int(t["warm_frames"]))
    refs = {p: Reference(vs, c["camera"], c["sun"], w, h, int(t["max_depth"]),
                         t["light_selection"], args.device, precision=p)
            for p in (("float32", "bfloat16") if args.control else ("float32",))}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        px, py = check.sample_pixels(seed, w, h, int(t["check_pixels"]))
        want = refs["float32"].pixels(px, py, args.frames, seed)
        row = {"workload": args.workload, "seed": seed, "frames": args.frames}
        if prog is not None:
            prog.renderer.reset_accumulation()
            prog.set_shot(seed)
            for _ in range(args.frames):
                prog.render()
            row["program_option"] = args.program_option
            row["program"] = check.compare(prog.display(px, py), want)
        if args.control:
            row["control"] = check.compare(
                refs["bfloat16"].pixels(px, py, args.frames, seed), want)
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
