"""ImState — auto-serialized, keyframeable configuration state.

Python port of the reference's ImGui-fused config system (imstate.{h,cpp}):
the same declaration drives defaults, (optional) UI, and .ini
serialization. Ini shape (imstate.cpp:227-377, 642-705):

- ``[Application][<target>]`` opens a target object's scope,
- ``[.][<name>]`` / ``[.][*<name>]`` opens a nested object scope (the ``*``
  variant forces a new object in array-like scopes),
- ``name= v0 v1 ...`` attributes (floats/ints/bools as space-separated
  values, strings raw),
- ``[;][<t>]`` starts a new *keyframe* settings frame with an absolute
  timecode, or relative when prefixed ``+``/``-`` (imstate.cpp:642-663),
- ``[Include][<file>]`` splices another ini, rebased to the including
  file's directory (imstate.cpp:666-705).

Instead of ImGui widgets, targets are plain Python objects (dataclasses)
registered with :meth:`ImState.register`; their public scalar/tuple fields
(and one level of nested dataclasses) are the serialized attributes.

Runtime keyframe replay matches imstate.cpp:821-898: ``have_new_settings``
/ ``handled_new_settings`` step through frames gated by timecode,
``append_frame`` / ``pad_frames`` / ``num_keyframes`` / ``current_keyframe``
/ ``last_keyframe_coming_up`` drive the profiling harness.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Dict, List, Optional, Tuple

from realtimepathtracingresearchframework_tpu_torch.utils.error_io import warning

_SECTION_RE = re.compile(r"^\[([^\]]*)\]\[([^\]]*)\]\s*$")


class SettingsFrame:
    """One keyframe: nested attribute strings per target."""

    def __init__(self, timeline_constraint: float = 0.0, source_file: str = ""):
        self.timeline_constraint = timeline_constraint
        self.source_file = source_file
        # target -> { (scope, path...) tuple -> {attr: raw string} }
        self.objects: Dict[str, Dict[Tuple[str, ...], Dict[str, str]]] = {}

    def scope(self, target: str, path: Tuple[str, ...]) -> Dict[str, str]:
        return self.objects.setdefault(target, {}).setdefault(path, {})


class ImState:
    def __init__(self):
        self.targets: Dict[str, Any] = {}
        self.settings: List[SettingsFrame] = []
        self.next_settings_index = 0
        self.app_ini_file: Optional[str] = None

    # ------------------------------------------------------------------
    # Registration (the IMGUI_STATE declaration analogue)
    # ------------------------------------------------------------------

    def register(self, target_name: str, obj: Any) -> None:
        """Register a (data)class instance as a serialization target."""
        self.targets[target_name] = obj

    # ------------------------------------------------------------------
    # Ini IO
    # ------------------------------------------------------------------

    def load_ini(self, path: str) -> None:
        """LoadSettings analogue: parse a file into settings frames. The
        first frame (timecode 0) holds base settings; ``[;]`` separators
        start subsequent keyframes."""
        with open(path) as f:
            text = f.read()
        self._parse(text, source=path)

    def loads(self, text: str, source: str = "<string>") -> None:
        self._parse(text, source)

    def _frame(self, source) -> SettingsFrame:
        if not self.settings:
            self.settings.append(SettingsFrame(0.0, source))
        return self.settings[-1]

    def _parse(self, text: str, source: str) -> None:
        cur_target: Optional[str] = None
        cur_path: Tuple[str, ...] = ()
        for raw_line in text.splitlines():
            line = raw_line.strip()
            if not line or line.startswith(";") or line.startswith("#"):
                continue
            if line.startswith(".."):
                # pop nested scope (imstate.cpp:576-581)
                cur_path = cur_path[:-1]
                continue
            m = _SECTION_RE.match(line)
            if m:
                section, name = m.group(1), m.group(2)
                if section == "Application":
                    self._frame(source)
                    cur_target = name
                    cur_path = ()
                elif section == ".":
                    cur_path = cur_path + (name.lstrip("*"),)
                elif section == ";":
                    prev = (
                        self.settings[-1].timeline_constraint
                        if self.settings
                        else 0.0
                    )
                    t = 0.0
                    try:
                        t = float(name) if name else 0.0
                    except ValueError:
                        pass
                    constraint = (
                        prev + t if name[:1] in "+-" else t
                    )
                    self.settings.append(SettingsFrame(constraint, source))
                    cur_target = None
                    cur_path = ()
                elif section == "Include":
                    base = os.path.dirname(source) if source else ""
                    inc = os.path.join(base, name) if base else name
                    if os.path.exists(inc):
                        self.load_ini(inc)
                    else:
                        warning("[Include] file not found: %s", inc)
                    cur_target = None
                    cur_path = ()
                else:
                    # other sections (e.g. ImGui window state) are ignored
                    cur_target = None
                continue
            if "=" in line and cur_target is not None:
                key, _, value = line.partition("=")
                frame = self._frame(source)
                frame.scope(cur_target, cur_path)[key.strip()] = value.strip()

    def serialize(self) -> str:
        """Write all registered targets (the auto-save path,
        imstate.cpp:900-912)."""
        out = []
        for target, obj in self.targets.items():
            out.append(f"\n[Application][{target}]")
            self._serialize_obj(out, obj, depth=0)
        return "\n".join(out) + "\n"

    def save_ini(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.serialize())

    def _serialize_obj(self, out: List[str], obj: Any, depth: int) -> None:
        for name, value in _fields_of(obj):
            if _is_nested(value):
                out.append("[.][%s]" % name)
                self._serialize_obj(out, value, depth + 1)
                out.append("..")  # scope pop (imstate.cpp:576-581)
            else:
                out.append("%s= %s" % (name, _format_value(value)))

    # ------------------------------------------------------------------
    # Widget schema (the ImGui half of the dual-mode declaration)
    # ------------------------------------------------------------------

    def describe(self) -> List[Dict[str, Any]]:
        """UI schema for every registered target — the widget half of the
        reference's IMGUI_STATE dual-mode macro (imstate.h:152-181),
        where one declaration is simultaneously a live widget and an ini
        attribute. The schema is produced by the SAME field walk the ini
        writer uses (:meth:`_serialize_obj`), and values are rendered by
        the same formatter, so a widget is exactly one ini line."""
        out: List[Dict[str, Any]] = []
        seen: set = set()
        for target, obj in self.targets.items():
            if id(obj) in seen:  # "Scene" / "Scene##id" alias one object
                continue
            seen.add(id(obj))
            groups: List[Dict[str, Any]] = []
            self._describe_obj(groups, obj, ())
            out.append({"target": target, "groups": groups})
        return out

    def _describe_obj(self, groups: List[Dict[str, Any]], obj: Any,
                      path: Tuple[str, ...]) -> None:
        attrs = []
        nested = []
        for name, value in _fields_of(obj):
            if _is_nested(value):
                nested.append((name, value))
            else:
                attrs.append({
                    "name": name,
                    "kind": _kind_of(value),
                    "value": _format_value(value).strip(),
                })
        if attrs:
            groups.append({"path": list(path), "attrs": attrs})
        for name, value in nested:
            self._describe_obj(groups, value, path + (name,))

    def apply_raw(self, target: str, path, attr: str, raw: str) -> bool:
        """Apply one widget edit through the SAME code path an ini
        attribute line takes (:func:`_apply_attr` after the scope walk of
        :meth:`_apply_frame`) — UI edits and ini lines are one pipeline,
        like the reference's ImState::Attribute (imstate.cpp:379-480)."""
        obj = self.targets.get(target)
        if obj is None:
            obj = self.targets.get(target.split("##")[0])
        if obj is None:
            return False
        for part in path:
            obj = _get_field(obj, part)
            if obj is None:
                return False
        _apply_attr(obj, attr, raw)
        return True

    # ------------------------------------------------------------------
    # Applying settings frames
    # ------------------------------------------------------------------

    def _apply_frame(self, frame: SettingsFrame) -> None:
        for target, scopes in frame.objects.items():
            obj = self.targets.get(target)
            if obj is None:
                # qualified-name fallback: "Scene##id" -> "Scene"
                base = target.split("##")[0]
                obj = self.targets.get(base)
            if obj is None:
                continue
            for path, attrs in scopes.items():
                node = obj
                ok = True
                for part in path:
                    node2 = _get_field(node, part)
                    if node2 is None:
                        ok = False
                        break
                    node = node2
                if not ok:
                    continue
                for attr, raw in attrs.items():
                    _apply_attr(node, attr, raw)

    def apply_base(self) -> None:
        """Apply the first settings frame (base configuration)."""
        if self.settings:
            self._apply_frame(self.settings[0])
            self.next_settings_index = max(self.next_settings_index, 1)

    # -- keyframe replay (imstate.cpp:821-898)

    def have_new_settings(self, timecode: float = 0.0) -> bool:
        if self.next_settings_index >= len(self.settings):
            return False
        # note: the reference's `if (timecode && ...)` quirk makes a zero
        # timecode apply everything; we gate strictly by the constraint so
        # replay from t=0 is well-defined.
        if timecode < self.settings[self.next_settings_index].timeline_constraint:
            return False
        return True

    def handled_new_settings(self) -> None:
        idx = self.next_settings_index
        if idx < len(self.settings):
            self._apply_frame(self.settings[idx])
        self.next_settings_index = idx + 1

    def append_frame(self, delay: float = 1.0) -> None:
        t = self.settings[-1].timeline_constraint if self.settings else 0.0
        self.settings.append(SettingsFrame(t + delay))

    def pad_frames(self, min_num_after_start: int) -> None:
        n_after = 0
        nf = len(self.settings)
        while (
            n_after < nf
            and n_after < min_num_after_start
            and self.settings[nf - 1 - n_after].timeline_constraint
        ):
            n_after += 1
        t = self.settings[-1].timeline_constraint if self.settings else 0.0
        while n_after < min_num_after_start:
            t += 1.0
            self.settings.append(SettingsFrame(t))
            n_after += 1

    def num_keyframes(self) -> int:
        return len(self.settings)

    def current_keyframe(self) -> int:
        return self.next_settings_index - 1

    def last_keyframe_coming_up(self, timecode: float) -> bool:
        nxt = self.next_settings_index
        last = self.num_keyframes() - 1
        return nxt > last or (
            nxt == last and timecode >= self.settings[nxt].timeline_constraint
        )


# ---------------------------------------------------------------------------
# value plumbing
# ---------------------------------------------------------------------------


def _fields_of(obj):
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield f.name, getattr(obj, f.name)
    else:
        for name, value in vars(obj).items():
            if not name.startswith("_"):
                yield name, value


def _is_nested(value) -> bool:
    return dataclasses.is_dataclass(value) or (
        hasattr(value, "__dict__") and not isinstance(value, (str, bytes))
        and not _is_scalar_seq(value)
    )


def _is_scalar_seq(value) -> bool:
    try:
        import numpy as np

        if isinstance(value, np.ndarray):
            return True
    except Exception:
        pass
    return isinstance(value, (list, tuple)) and all(
        isinstance(v, (int, float, bool)) for v in value
    )


def _format_value(value) -> str:
    import numpy as np

    if isinstance(value, bool):
        return " %d" % int(value)
    if isinstance(value, (int,)):
        return " %d" % value
    if isinstance(value, float):
        return " %e" % value
    if isinstance(value, np.ndarray):
        return " " + " ".join("%e" % float(v) for v in value.reshape(-1))
    if isinstance(value, (list, tuple)):
        return " " + " ".join(_format_value(v).strip() for v in value)
    return str(value)


def _kind_of(value) -> str:
    """Widget kind for a serializable leaf value (drives the client-side
    input element: checkbox / number / N-number row / text)."""
    import numpy as np

    if isinstance(value, bool):
        return "bool"
    if isinstance(value, int):
        return "int"
    if isinstance(value, float):
        return "float"
    if isinstance(value, np.ndarray):
        return "vec%d" % value.size
    if isinstance(value, (list, tuple)):
        return "vec%d" % len(value)
    return "str"


def _get_field(obj, name):
    """Attribute lookup, case-insensitive on miss: the reference's ini
    labels use display capitalization ("[.][Camera]",
    scene_state.h:30-115) while our dataclass fields are snake_case —
    reference-written inis (e.g. the Blender camera-path exporter) must
    load here."""
    v = getattr(obj, name, None)
    if v is not None:
        return v
    low = name.lower()
    for attr in dir(obj):
        if attr.lower() == low and not attr.startswith("_"):
            return getattr(obj, attr)
    return None


def _apply_attr(obj, name: str, raw: str) -> None:
    import numpy as np

    if not hasattr(obj, name):
        # case-insensitive fallback, matching _get_field's scope lookup:
        # reference-written inis capitalize attribute lines too
        # ("Position= 1 2 3" onto CameraState.position)
        low = name.lower()
        name = next(
            (
                a for a in dir(obj)
                if a.lower() == low and not a.startswith("_")
            ),
            name,
        )
    cur = getattr(obj, name, None)
    if cur is None and not hasattr(obj, name):
        return
    try:
        parts = raw.split()
        if isinstance(cur, bool):
            setattr(obj, name, bool(int(float(parts[0]))))
        elif isinstance(cur, int):
            setattr(obj, name, int(float(parts[0])))
        elif isinstance(cur, float):
            setattr(obj, name, float(parts[0]))
        elif isinstance(cur, np.ndarray):
            vals = np.array([float(p) for p in parts], cur.dtype)
            setattr(obj, name, vals.reshape(cur.shape) if vals.size == cur.size else cur)
        elif isinstance(cur, tuple):
            vals = [float(p) for p in parts]
            setattr(obj, name, tuple(vals[: len(cur)] if cur else vals))
        elif isinstance(cur, list):
            setattr(obj, name, [float(p) for p in parts])
        else:  # string-ish
            setattr(obj, name, raw)
    except (ValueError, IndexError):
        warning("imstate: failed to parse %s=%s", name, raw)
