"""ctypes loader for the native host library native/libfxnative.so (a copy
of fluidx12_tpu/utils/native.py's loader).

The library holds two host services, a PNG encoder (`fx_write_png`) and a
BC6H decoder (`fx_decode_bc6h`); it is built with `make -C native` and is
optional: utils/png.py and gi/dds.py fall back to their numpy versions
where it is absent.  It runs on the host, not on the card.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _candidate_paths():
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    yield os.path.join(root, "native", "libfxnative.so")
    yield os.path.join(os.path.dirname(__file__), "libfxnative.so")


def get_native_lib() -> Optional[ctypes.CDLL]:
    """Load and memoize the native library; None if unavailable."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    for path in _candidate_paths():
        if os.path.exists(path):
            try:
                lib = ctypes.CDLL(path)
                _configure(lib)
                _lib = lib
                break
            except OSError:
                continue
    return _lib


def _configure(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.fx_decode_bc6h.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p]
    lib.fx_decode_bc6h.restype = None
    lib.fx_write_png.argtypes = [
        ctypes.c_char_p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int
    ]
    lib.fx_write_png.restype = ctypes.c_int
