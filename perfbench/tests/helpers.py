"""Test data: a benchmark whose cells live only under ``tests/data``."""

import copy

from perfbench.cells import HERE, ROOT, load_json

DATA = HERE / "tests" / "data"
SEARCH = (DATA, HERE)
TINY_CELLS = {
    "tiny-village": ("tiny-village", "tiny"),
    "tiny-terrain": ("tiny-terrain", "tiny"),
    "tiny-village-ris": ("tiny-village", "tiny-ris"),
}


def bench_with_tiny_cells() -> dict:
    """``BENCHMARK.json`` with the tiny cells and a metric that only the
    test data defines (``frames_traced``)."""
    bench = copy.deepcopy(load_json(ROOT / "BENCHMARK.json"))
    bench["configs"] += [
        {"name": c, "source": "test data", "file": f"perfbench/tests/data/configs/{c}.json",
         "reduced": ["builder_args"], "why": "a tiny frame for the CPU tests"}
        for c in ("tiny-village", "tiny-terrain")]
    bench["workloads"] += [
        {"name": n, "config": c, "traffic": t, "chips": 1, "why": "CPU test"}
        for n, (c, t) in TINY_CELLS.items()]
    bench["per_layer"].append(
        {"name": "frames_traced", "unit": "frames", "better": "higher",
         "source": "device_trace", "layer": "device", "moves": "frame_ms",
         "workloads": ["tiny-village"]})
    return bench
