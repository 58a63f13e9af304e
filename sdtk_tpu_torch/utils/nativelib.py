"""The host library (``csrc/host/*.cc``: WAV decode and resampling, the
threaded batch loader and BLAKE3), built by ``utils/build.py:build_host``
at first use and bound with ``ctypes`` under the JAX package's C ABI.

A failed build raises :class:`~sdtk_tpu_torch.utils.build.KernelError`.
``SDTK_NO_NATIVE_BUILD=1`` asks for no build: a library already built is
loaded, and otherwise :func:`get_lib` returns ``None`` and callers take
their Python path.
"""

from __future__ import annotations

import ctypes
import os
import threading

from . import build

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def get_lib() -> ctypes.CDLL | None:
    """The bound host library, built first unless ``SDTK_NO_NATIVE_BUILD=1``
    (then ``None`` when it is not built)."""
    global _lib
    with _lock:
        if _lib is None:
            path = build.host_library_path()
            if not path.exists():
                if os.environ.get("SDTK_NO_NATIVE_BUILD") == "1":
                    return None
                path = build.build_host()
            lib = ctypes.CDLL(str(path))
            _declare(lib)
            _lib = lib
        return _lib


def _declare(lib: ctypes.CDLL) -> None:
    lib.sdtk_blake3.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p]
    lib.sdtk_blake3.restype = None

    lib.sdtk_decode_wav.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.sdtk_decode_wav.restype = ctypes.c_int

    lib.sdtk_decode_wav_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.sdtk_decode_wav_batch.restype = None

    lib.sdtk_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    lib.sdtk_free.restype = None
