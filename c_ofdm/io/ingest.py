"""Python binding for the native ingest runtime (native/ingest.cpp).

Replaces the reference's SDR double-buffer thread (`rx.cpp:48-66`): a C++
producer thread pulls int16-IQ buffers from a file/fd/synthetic source into a
slot ring; ``pop()`` drains one buffer as float32 IQ ready for device upload.
Built from source with ``make`` on first use in each process (a no-op when
the library is newer than its source); the built library is never shipped.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libingest.so"))

SRC_FILE_REPLAY = 0
SRC_FD_STREAM = 1
SRC_SYNTH_ZERO = 2


class IngestStats(ctypes.Structure):
    _fields_ = [
        ("buffers_produced", ctypes.c_uint64),
        ("buffers_consumed", ctypes.c_uint64),
        ("bytes_ingested", ctypes.c_uint64),
        ("producer_waits", ctypes.c_uint64),
        ("consumer_waits", ctypes.c_uint64),
    ]


_lib: Optional[ctypes.CDLL] = None


def _build() -> None:
    subprocess.run(["make", "-C", os.path.abspath(_NATIVE_DIR), "-s"],
                   check=True)


def load_library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    _build()
    lib = ctypes.CDLL(_LIB_PATH)
    lib.ingest_create.restype = ctypes.c_void_p
    lib.ingest_create.argtypes = [ctypes.c_int32, ctypes.c_char_p,
                                  ctypes.c_int64, ctypes.c_int32]
    lib.ingest_pop_f32.restype = ctypes.c_int32
    lib.ingest_pop_f32.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_float),
                                   ctypes.c_int32]
    lib.ingest_pop_i16.restype = ctypes.c_int32
    lib.ingest_pop_i16.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_int16),
                                   ctypes.c_int32]
    lib.ingest_stats.argtypes = [ctypes.c_void_p, ctypes.POINTER(IngestStats)]
    lib.ingest_destroy.argtypes = [ctypes.c_void_p]
    lib.convert_i16_to_f32.argtypes = [ctypes.POINTER(ctypes.c_int16),
                                       ctypes.POINTER(ctypes.c_float),
                                       ctypes.c_int64]
    _lib = lib
    return lib


class NativeIngest:
    """Double-buffered native ingest source.

    samples_per_buf: complex samples per pop (reference: rx_buf_size frames).
    """

    def __init__(self, kind: int, source: str, samples_per_buf: int,
                 n_slots: int = 4):
        self._lib = load_library()
        self.samples_per_buf = samples_per_buf
        self._ring = self._lib.ingest_create(
            kind, source.encode(), samples_per_buf, n_slots)
        if not self._ring:
            raise OSError(f"ingest_create failed for {source!r}")

    def pop_f32(self, timeout_ms: int = 1000) -> Optional[np.ndarray]:
        """One buffer as interleaved float32 IQ [2*samples] or None on EOF."""
        out = np.empty(self.samples_per_buf * 2, dtype=np.float32)
        rc = self._lib.ingest_pop_f32(
            self._ring, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            timeout_ms)
        if rc == 1:
            return out
        if rc == 0:
            return None
        raise TimeoutError("ingest pop timed out")

    def pop_complex64(self, timeout_ms: int = 1000) -> Optional[np.ndarray]:
        raw = self.pop_f32(timeout_ms)
        if raw is None:
            return None
        return raw.view(np.complex64)

    def pop_i16(self, timeout_ms: int = 1000) -> Optional[np.ndarray]:
        out = np.empty(self.samples_per_buf * 2, dtype=np.int16)
        rc = self._lib.ingest_pop_i16(
            self._ring, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            timeout_ms)
        if rc == 1:
            return out
        if rc == 0:
            return None
        raise TimeoutError("ingest pop timed out")

    def stats(self) -> IngestStats:
        s = IngestStats()
        self._lib.ingest_stats(self._ring, ctypes.byref(s))
        return s

    def close(self):
        if self._ring:
            self._lib.ingest_destroy(self._ring)
            self._ring = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def convert_i16_to_f32(src: np.ndarray) -> np.ndarray:
    """Standalone native int16 -> float32 (Frame.hpp:472-516 counterpart)."""
    lib = load_library()
    src = np.ascontiguousarray(src, dtype=np.int16)
    dst = np.empty(src.size, dtype=np.float32)
    lib.convert_i16_to_f32(src.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                           dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                           src.size)
    return dst.reshape(src.shape)
