"""The plain reference that decides ``correct``: a path tracer in plain
PyTorch and NumPy that imports nothing of the program. Its modules are
frozen copies of the port's plain host and shading code, kept here so
that the yardstick does not move with the program, plus its own BVH
(``walk.py``) in place of the program's packs and kernels."""
