"""The port's interactive viewer (``app/viewer.py``) on the CPU:
``tests/test_viewer.py``'s three cases run over the port's viewer, state
and ``Renderer(device="cpu")`` (``test_torch_imstate.port_case``): the HTTP
surface serves frames and stats, key and mouse input move the camera,
the settings widgets edit the state and the variant, and the ini is
persisted on exit (in the test's ``tmp_path``, never the user's home).
"""

import functools
import sys

import pytest
import torch

sys.path.insert(0, __file__.rsplit("/", 1)[0])
import test_viewer as ref_cases  # noqa: E402
from test_torch_imstate import port_case  # noqa: E402
from realtimepathtracingresearchframework_tpu_torch.app import imstate as tims
from realtimepathtracingresearchframework_tpu_torch.app import state as tstate
from realtimepathtracingresearchframework_tpu_torch.app import viewer as tviewer
from realtimepathtracingresearchframework_tpu_torch.backend import renderer as trend
from realtimepathtracingresearchframework_tpu_torch.models import procedural as tproc
from realtimepathtracingresearchframework_tpu_torch.models.scene import Scene as TScene

# One torch thread per test process: the tier-1 run has six xdist workers
# on the machine's cores, and torch's OpenMP threads then oversubscribe them
torch.set_num_threads(1)

REF_CASES = sorted(n for n in vars(ref_cases) if n.startswith("test_"))


@pytest.mark.parametrize("case", REF_CASES)
def test_reference_viewer_case_on_port(case, tmp_path, monkeypatch):
    fn = port_case(
        ref_cases, case, monkeypatch, modules=("app.imstate", "app.state"),
        Renderer=functools.partial(trend.Renderer, device="cpu"),
        Scene=TScene, procedural=tproc, ImState=tims.ImState,
        AppStateBundle=tstate.AppStateBundle,
        InteractiveViewer=tviewer.InteractiveViewer)
    fn(tmp_path)


def test_port_viewer_renders_through_the_port(tmp_path):
    """The viewer's renderer is the port's, its frames are PNGs of the
    frame size, and a quit ends the loop."""
    import json
    import threading
    import time
    import urllib.request

    r = trend.Renderer(device="cpu")
    r.initialize(24, 16)
    r.set_scene(TScene.from_vkr_scene(tproc.cornell_box()))
    ims = tims.ImState()
    bundle = tstate.AppStateBundle(ims, "")
    bundle.app.max_path_depth = 2
    v = tviewer.InteractiveViewer(r, bundle, ims, port=0, watch_rebuild=False,
                                  app_ini=str(tmp_path / "app.ini"))
    t = threading.Thread(target=v.run, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{v.port}"
    try:
        png = b""
        for _ in range(600):
            with urllib.request.urlopen(url + "/frame", timeout=30) as resp:
                png = resp.read()
            if png.startswith(b"\x89PNG"):
                break
            time.sleep(0.05)
        with urllib.request.urlopen(url + "/stats", timeout=30) as resp:
            stats = json.loads(resp.read())
    finally:
        req = urllib.request.Request(url + "/quit", data=b"{}", method="POST")
        urllib.request.urlopen(req, timeout=30).read()
        t.join(timeout=60)
    assert not t.is_alive()
    assert png.startswith(b"\x89PNG")
    # the PNG's IHDR: width and height, big-endian, at bytes 16-24
    assert int.from_bytes(png[16:20], "big") == 24
    assert int.from_bytes(png[20:24], "big") == 16
    assert stats["width"] == 24 and stats["height"] == 16 and stats["spp"] >= 1
    assert r.frame_id >= 1 and isinstance(r.device, torch.device)
