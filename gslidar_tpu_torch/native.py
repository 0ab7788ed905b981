"""Loader for the repository's native C++ data-path extension (the port's
copy of gslidar_tpu/native.py).

``get_native()`` returns the compiled module (``native/`` at the
repository root: the velodyne reader and the panorama z-buffer) or None,
and the callers then use their numpy fallbacks. The extension is built on
first use with g++ by ``native/build.py`` and cached beside its source.
"""

from __future__ import annotations

import importlib.util
import os
import sys

_native = None
_tried = False


def get_native():
    global _native, _tried
    if _tried:
        return _native
    _tried = True
    try:
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        if repo not in sys.path:
            sys.path.insert(0, repo)
        from native.build import build
        so_path = build()
        spec = importlib.util.spec_from_file_location("gslidar_native",
                                                      so_path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _native = mod
    except Exception as e:  # pragma: no cover - env specific
        print(f"[native] extension unavailable ({e}); using numpy fallbacks")
        _native = None
    return _native
