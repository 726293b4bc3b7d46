"""Best-effort secret wiping: the port's own copy of
`crypto_tpu/utils/zeroize.py` (reference: `Zeroize`/`ZeroizeOnDrop`
derives on every secret type, e.g. `schnorr_pok/src/discrete_log.rs:30`).

Python cannot guarantee memory erasure of immutable ints (the interpreter
may hold interned copies, and big-int limbs live in GC-managed buffers), so
this module provides the best achievable semantics:

* `zeroize(obj)` — recursively overwrites the *references* held by an
  object's fields with zero values so the secret becomes unreachable from
  the object graph and is garbage-collected promptly; mutable buffers
  (bytearray / numpy arrays) ARE wiped in place.
* `wipe_bytes(buf)` — in-place zero of a bytearray / writable memoryview /
  numpy array.

Secret types expose `.zeroize()` via `ZeroizeMixin` (the accumulator's
`AccumSecretKey`).
"""

from __future__ import annotations

import dataclasses


def wipe_bytes(buf) -> None:
    """In-place zeroization of mutable byte-like buffers."""
    try:
        import numpy as np
        if isinstance(buf, np.ndarray):
            buf.fill(0)
            return
    except ImportError:          # pragma: no cover
        pass
    if isinstance(buf, bytearray):
        for i in range(len(buf)):
            buf[i] = 0
        return
    if isinstance(buf, memoryview) and not buf.readonly:
        buf[:] = b"\x00" * len(buf)
        return
    raise TypeError(f"cannot wipe immutable buffer of type {type(buf)!r}")


def zeroize(obj) -> None:
    """Overwrite an object's fields: mutable buffers are wiped in place,
    field elements / ints are replaced by zero, containers recursed."""
    if obj is None:
        return
    if isinstance(obj, (bytearray, memoryview)):
        wipe_bytes(obj)
        return
    try:
        import numpy as np
        if isinstance(obj, np.ndarray):
            obj.fill(0)
            return
    except ImportError:          # pragma: no cover
        pass
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, (bytearray, memoryview)):
                wipe_bytes(v)
            elif isinstance(v, (list, dict, tuple)):
                _zero_container(obj, f.name, v)
            elif isinstance(v, int):
                object.__setattr__(obj, f.name, 0)
            elif hasattr(v, "is_zero") and hasattr(v, "f"):
                # host field element -> replace with additive identity
                object.__setattr__(obj, f.name, type(v)(0, v.f)
                                   if hasattr(v, "f") else 0)
            elif dataclasses.is_dataclass(v):
                zeroize(v)
        return
    # generic object with __dict__
    for k in list(getattr(obj, "__dict__", {})):
        obj.__dict__[k] = None


def _zero_container(obj, name, v):
    if isinstance(v, list):
        for item in v:
            if isinstance(item, (bytearray, memoryview)):
                wipe_bytes(item)
        object.__setattr__(obj, name, [])
    elif isinstance(v, dict):
        object.__setattr__(obj, name, {})
    else:
        object.__setattr__(obj, name, ())


class ZeroizeMixin:
    """Adds `.zeroize()` to secret dataclasses."""

    def zeroize(self) -> None:
        zeroize(self)
