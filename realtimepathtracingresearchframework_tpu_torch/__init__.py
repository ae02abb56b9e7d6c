"""PyTorch/CUDA port of the real-time path tracing research framework.

The JAX package ``realtimepathtracingresearchframework_tpu`` is the
reference; this package re-expresses its renderer in PyTorch, with every
Pallas kernel on a ported path rewritten by hand for Hopper (CUDA C++ under
``csrc/``, built by ``kernels/build.py``). It imports neither JAX nor any
module of the JAX package: the numpy host modules it needs (params, scene
and its loaders, procedural scenes, BVH build, camera, lights, materials,
the Hosek cook and its data, image IO, profiling, the native decoders'
bindings) are copied here under the same names and places.

Layer map:
  - ``models``  : scenes, camera, lights, materials, the sky (host cook and
                  device evaluation)
  - ``ops``     : vec3, RNG, intersection, BVH build, traversal (plain
                  versions + the kernels' wrappers: resident walk K1,
                  flat cull K2/K3, coherence sort), BSDF, NEE, integrator,
                  the bounce-major wavefront executor, resolve
  - ``kernels`` : nvcc build + ctypes loading of ``csrc/*.cu``
  - ``backend`` : params and the ``Renderer`` (explicit ``device``)
  - ``app``     : the CLI (``python -m ...app.cli``), its run modes
                  (validation, profiling, data capture), the localhost
                  viewer, ini state and relaunch-on-rebuild
  - ``tools``   : scene and texture tools (vkr2obj, vktconvert, vktinfo,
                  the Blender exporter's core, prepare_sobol)
  - ``utils``   : color, image IO (PFM/EXR), compare, profiling
"""

__version__ = "0.1.0"

from realtimepathtracingresearchframework_tpu_torch.backend.params import (  # noqa: F401
    RenderBackendOptions,
    RenderParams,
    SceneConfig,
)
