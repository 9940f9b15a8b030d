"""The native decode of a ``POST /predict`` body (``csrc/predict_body.cpp``).

A replica's handler decodes each request body into a float32 array before
it submits the rows.  The JAX server does it in the interpreter,

    doc = json.loads(body); x = np.asarray(doc["inputs"], dtype=np.float32)

which for a 128 × 55 body of 17-digit floats holds the interpreter lock for
milliseconds, the batcher's lane waiting behind it.  :func:`decode` gives
the same array, bit for bit, from host C++ called through ``ctypes``, which
releases the lock for the call.  It takes only the body shape the library
accepts (its header says which) and returns ``None`` for any other body,
which the caller then decodes exactly as the JAX server does — so a
malformed body's 400 and its message stay the reference's.

:func:`routing_key` is the fleet router's front door's use of the same
decode: the tenant a body names, read without building a Python float.

The library is built from the checkout's source with the host compiler at
first use (``ops/_build.py``); a missing compiler or a failed build raises.
"""

from __future__ import annotations

import ctypes
import json
from typing import Optional, Tuple

import numpy as np

from dist_svgd_torch.ops import _build

_I64x2 = ctypes.c_int64 * 2


def load() -> ctypes.CDLL:
    """The decoder library, built and loaded on first use."""
    lib = _build.library("predict_body")
    fn = lib.predict_body_decode
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_int64, _I64x2, _I64x2]
        fn.restype = ctypes.c_int
    return lib


def decode(body: bytes) -> Optional[Tuple[np.ndarray, Optional[str]]]:
    """``(x, tenant)`` for a body the library accepts: ``x`` the float32
    ``(rows, cols)`` array JAX's decode gives (a flat ``"inputs"`` is one
    row), ``tenant`` the body's ``"tenant"`` string or ``None`` without
    one.  ``None`` when the body is declined (or is not ``bytes``)."""
    if not isinstance(body, bytes):
        return None
    # each number takes at least one byte and a separator after it
    buf = np.empty(len(body) // 2 + 1, dtype=np.float32)
    shape, tenant = _I64x2(), _I64x2()
    if not load().predict_body_decode(body, len(body), buf.ctypes.data, buf.size,
                                      shape, tenant):
        return None
    name = (None if tenant[0] < 0
            else body[tenant[0]:tenant[0] + tenant[1]].decode("ascii"))
    return buf[:shape[0] * shape[1]].reshape(shape[0], shape[1]), name


def routing_key(body: bytes) -> str:
    """The fleet front door's routing key for ``body``: JAX's ``doc.get(
    "tenant") or ""`` (``""`` for a body that is not JSON or not an
    object).  A body the library accepts gives its tenant without a Python
    float built; any other goes through JAX's own ``json.loads``."""
    native = decode(body)
    if native is not None:
        return native[1] or ""
    try:
        doc = json.loads(body or b"null")
        return doc.get("tenant") or "" if isinstance(doc, dict) else ""
    except ValueError:
        return ""
