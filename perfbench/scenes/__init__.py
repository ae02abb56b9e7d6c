"""The cells' input scenes, made by the benchmark itself.

A configuration names its builder (``"builder"``) and the builder's
arguments (``"builder_args"``); the builder is ``scenes/<builder>.py``,
whose ``build(**builder_args)`` returns a ``.vks``-style scene
(``scenes/vks.py``). Both the program and the reference get that same
scene. The builders are frozen copies of the port's procedural builders
(``models/procedural.py``), so a change there moves neither side. A new
scene is a new file here and a new configuration; nothing here changes.
"""

from __future__ import annotations

import importlib


def build(config: dict):
    """The input scene of ``config``."""
    module = importlib.import_module(f"perfbench.scenes.{config['builder']}")
    return module.build(**config["builder_args"])
