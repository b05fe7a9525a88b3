"""Typed run configuration + a reader for its flat YAML schema.

Port of ``vo_tpu/config.py``: the reference's keys (``vo_method``,
``feature_extractor``, ``image_path``, ``camera_intrinsic_matrix`` (9 numbers),
``output_filename``, ``visualize_results``, ``gt_txt_file_path``, ``poses_file_path``)
plus the engine's (``max_keypoints``, ``extraction_batch``, ``octaves``, ``oriented``,
``matcher``, ``ratio``, the gates, ``pnp_*``), resolved into the port's ``VOConfig`` /
``PnPConfig`` exactly as there.

The schema is one flat mapping, so ``read_flat_yaml`` reads it without PyYAML: it
takes ``key: value`` lines and comments; ints, floats, bools, nulls (also an empty
value) and quoted or bare strings, resolved as PyYAML's ``safe_load`` resolves them;
and lists of such scalars in flow (``[a, b, ...]``) or block (``- a``) style. It raises
on anything else (a nested mapping, a flow mapping, anchors, tags, multi-line strings).
"""

from __future__ import annotations

import json
import math
import re
from dataclasses import dataclass, field

import numpy as np

from vo_tpu_torch.engine.vo import VOConfig
from vo_tpu_torch.estimation.pnp import PnPConfig

# YAML 1.1 implicit scalars, as PyYAML's resolver matches them (sexagesimal numbers
# excepted: they raise).
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_SEXAGESIMAL = re.compile(r"^[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$")
_KEY = re.compile(r"^([A-Za-z_][A-Za-z0-9_.\-]*)\s*:(?:\s+(.*))?$")


def _int(text: str) -> int:
    t = text.replace("_", "")
    sign = -1 if t.startswith("-") else 1
    t = t.lstrip("+-")
    if t.startswith("0b"):
        return sign * int(t[2:], 2)
    if t.startswith("0x"):
        return sign * int(t[2:], 16)
    if len(t) > 1 and t.startswith("0"):
        return sign * int(t, 8)
    return sign * int(t)


def _float(text: str) -> float:
    t = text.replace("_", "").lower()
    if t.endswith(".inf"):
        return -math.inf if t.startswith("-") else math.inf
    if t.endswith(".nan"):
        return math.nan
    return float(t)


def _scalar(text: str, where: str):
    """One plain or quoted scalar, resolved as ``yaml.safe_load`` resolves it."""
    t = text.strip()
    if t[:1] == "'":
        if len(t) < 2 or t[-1] != "'":
            raise ValueError(f"{where}: unterminated quoted string {t!r}")
        return t[1:-1].replace("''", "'")
    if t[:1] == '"':
        if len(t) < 2 or t[-1] != '"':
            raise ValueError(f"{where}: unterminated quoted string {t!r}")
        return json.loads(t)
    if t[:1] in ("[", "]", "{", "}", "&", "*", "!", "|", ">", "@", "`", "%") \
            or ": " in t or t.endswith(":"):
        raise ValueError(f"{where}: unsupported YAML value {t!r} (the config is one "
                         "flat mapping of scalars and lists of numbers)")
    if _NULL.match(t):
        return None
    if _BOOL.match(t):
        return t.lower() in ("yes", "true", "on")
    if _INT.match(t):
        return _int(t)
    if _FLOAT.match(t):
        return _float(t)
    if _SEXAGESIMAL.match(t):
        raise ValueError(f"{where}: sexagesimal number {t!r} is not supported")
    return t


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment (at the line's start or after a space, outside quotes)."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"":
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _flow_list(text: str, where: str) -> list:
    inner = text.strip()[1:-1]
    items, cur, quote = [], "", None
    for c in inner:
        if quote:
            quote = None if c == quote else quote
        elif c in "'\"":
            quote = c
        elif c in "[]{}":
            raise ValueError(f"{where}: nested collections are not supported")
        elif c == ",":
            items.append(cur)
            cur = ""
            continue
        cur += c
    items.append(cur)
    if items and not items[-1].strip():        # a trailing comma
        items.pop()
    return [_scalar(x, where) for x in items]


def read_flat_yaml(text: str, name: str = "<yaml>") -> dict:
    """The flat mapping of a config file (see the module docstring)."""
    out: dict = {}
    lines = text.splitlines()
    i = 0
    open_key = None   # a key with an empty value: a block list may follow
    while i < len(lines):
        where = f"{name}:{i + 1}"
        line = _strip_comment(lines[i]).rstrip()
        i += 1
        if not line.strip() or (line.strip() in ("---", "...") and line[0] in "-."):
            continue
        if line.lstrip().startswith("- ") or line.strip() == "-":
            if open_key is None:
                raise ValueError(f"{where}: a list item outside a key's value")
            item = line.strip()[1:]
            if out[open_key] is None:
                out[open_key] = []
            out[open_key].append(_scalar(item, where))
            continue
        if line[0] in " \t":
            raise ValueError(f"{where}: nested mappings are not supported: {line.strip()!r}")
        m = _KEY.match(line)
        if m is None:
            raise ValueError(f"{where}: not a 'key: value' line: {line!r}")
        key, value = m.group(1), (m.group(2) or "").strip()
        open_key = None
        if value.startswith("["):
            while value.count("[") != value.count("]") and i < len(lines):
                value += " " + _strip_comment(lines[i]).strip()
                i += 1
            if not value.endswith("]"):
                raise ValueError(f"{where}: unterminated or unsupported flow list")
            out[key] = _flow_list(value, where)
        elif not value:
            out[key] = None
            open_key = key
        else:
            out[key] = _scalar(value, where)
    return out


@dataclass
class RunConfig:
    vo_method: str = "rgbd"              # 'rgbd' | 'mono'
    feature_extractor: str = "orb"       # 'orb' | 'sift' | 'surf' | 'r2d2'
    image_path: str = ""
    camera_intrinsic_matrix: np.ndarray = field(
        default_factory=lambda: np.array(
            [[721.53, 0.0, 609.55], [0.0, 721.53, 172.85], [0.0, 0.0, 1.0]], np.float32))
    output_filename: str = "global_poses"
    visualize_results: bool = False
    gt_txt_file_path: str = ""
    poses_file_path: str = ""

    max_keypoints: int = 2048
    extraction_batch: int = 16
    octaves: int = 1             # > 1: the octave-pyramid extractor (features/pyramid.py)
    oriented: bool = False       # gradhist dominant-orientation normalisation
    vo: VOConfig = field(default_factory=VOConfig)

    @classmethod
    def from_yaml(cls, path: str) -> "RunConfig":
        with open(path) as f:
            raw = read_flat_yaml(f.read(), path)
        cfg = cls()
        if "vo_method" in raw:
            cfg.vo_method = raw["vo_method"]
        if "feature_extractor" in raw:
            cfg.feature_extractor = raw["feature_extractor"]
        if "image_path" in raw:
            cfg.image_path = raw["image_path"] or ""
        if "camera_intrinsic_matrix" in raw:
            cfg.camera_intrinsic_matrix = np.reshape(
                np.asarray(raw["camera_intrinsic_matrix"], np.float32), (3, 3))
        if "output_filename" in raw:
            cfg.output_filename = raw["output_filename"]
        if "visualize_results" in raw:
            cfg.visualize_results = bool(raw["visualize_results"])
        if "gt_txt_file_path" in raw:
            cfg.gt_txt_file_path = raw["gt_txt_file_path"] or ""
        if "poses_file_path" in raw:
            cfg.poses_file_path = raw["poses_file_path"] or ""
        if "max_keypoints" in raw:
            cfg.max_keypoints = int(raw["max_keypoints"])
        if "extraction_batch" in raw:
            cfg.extraction_batch = int(raw["extraction_batch"])
        if "octaves" in raw:
            cfg.octaves = int(raw["octaves"])
        if "oriented" in raw:
            cfg.oriented = bool(raw["oriented"])

        vo_kwargs = {}
        if cfg.feature_extractor in ("orb",):
            vo_kwargs["matcher"] = "ratio_binary"
            vo_kwargs["ratio"] = 0.85      # the reference's ORB.py:28
        elif cfg.feature_extractor in ("sift", "surf"):
            vo_kwargs["matcher"] = "ratio_float"
            vo_kwargs["ratio"] = 0.85      # SIFT.py:27, SURF.py:26
        elif cfg.feature_extractor == "r2d2":
            vo_kwargs["matcher"] = "ratio_mutual_nn"
            vo_kwargs["ratio"] = 0.90      # R2D2.py:53
        for k in ("ratio", "matcher", "min_displacement_px", "max_point_depth",
                  "max_speed", "kf_min_matches", "kf_min_inliers", "bad_pnp_limit"):
            if k in raw:
                vo_kwargs[k] = raw[k]
        pnp_kwargs = {k[4:]: raw[k] for k in raw
                      if k.startswith("pnp_") and k[4:] in PnPConfig.__dataclass_fields__}
        if pnp_kwargs:
            vo_kwargs["pnp"] = PnPConfig(**pnp_kwargs)
        cfg.vo = VOConfig(**vo_kwargs)
        return cfg
