"""Scene/texture tooling (ext/libvkr/scripts equivalents): vkrinfo
(models/vkr.py main), vkr2obj, vktinfo, vktconvert, blender_vkr, and
prepare_sobol (rendering/tools/prepare_sobol.cpp)."""
