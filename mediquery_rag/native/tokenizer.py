"""ctypes wrapper over native/libtokenizer.so (C++ batch tokenizer).

The host-side data-loader hot path: pure-Python per-character hashing runs
~1.4 Mchar/s, far below what the device embedder consumes during ingest. The
C++ path implements the exact same codepoint slice / isspace skip /
splitmix hash (native/tokenizer.cpp) — exactness is load-bearing because
the embedder fingerprint, and therefore every persisted index, depends on
tokenization (tests/test_native.py asserts Python == native on adversarial
inputs). Auto-builds with `make -C native`; callers fall back to the
Python loop when a compiler is unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO, "native")
_SO = os.path.join(_NATIVE_DIR, "libtokenizer.so")

_lib = None
_failed = False


def _load():
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    try:
        src = os.path.join(_NATIVE_DIR, "tokenizer.cpp")
        stale = (not os.path.exists(_SO)
                 or (os.path.exists(src)
                     and os.path.getmtime(src) > os.path.getmtime(_SO)))
        if stale:
            # mtime-aware rebuild: a stale .so would silently change
            # tokenization (and the embedder fingerprint) vs the source
            subprocess.run(["make", "-C", _NATIVE_DIR, "libtokenizer.so"],
                           check=True, capture_output=True)
        lib = ctypes.CDLL(_SO)
        lib.tok_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.tok_batch.restype = None
        _lib = lib
    except (OSError, subprocess.CalledProcessError):
        _failed = True
    return _lib


def native_available() -> bool:
    return _load() is not None


def tok_batch(texts: list[str], vocab_size: int, slice_len: int,
              cap_len: int) -> tuple[np.ndarray, np.ndarray]:
    """Tokenize a batch natively. Returns (ids [B, cap_len] i32, lens [B]).

    Raises RuntimeError if the native library is unavailable — callers
    (HashCharTokenizer.batch_encode) check ``native_available`` first.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("libtokenizer.so unavailable")
    raw = [t.encode("utf-8") for t in texts]
    buf = b"".join(raw)
    offsets = np.zeros(len(texts) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in raw], out=offsets[1:])
    buf_arr = np.frombuffer(buf, dtype=np.uint8) if buf else np.zeros(1, np.uint8)
    ids = np.empty((len(texts), cap_len), dtype=np.int32)
    lens = np.empty(len(texts), dtype=np.int32)
    lib.tok_batch(
        buf_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(texts), vocab_size, slice_len, cap_len,
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return ids, lens
