# Note: `compare` is intentionally not eagerly imported so that
# `python -m realtimepathtracingresearchframework_tpu_torch.utils.compare` works
# without a runpy double-import warning.
from realtimepathtracingresearchframework_tpu_torch.utils import (  # noqa: F401
    color,
    error_io,
    image_io,
    online_stats,
    profiling,
)
