"""Multi-device rendering: device lists and grids (``mesh.py``), the row-band
and 2-D tile sharded renders (``render_sharded.py``) and the one-step entry
points (``dryrun.py``), the counterparts of the reference's ``parallel/``
package and ``__graft_entry__.py``. ``Renderer(devices=...)`` is the product
path; these render one frame over an explicit list of devices."""
