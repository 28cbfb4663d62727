"""The payload codec of the AOT library cache, the port's counterpart of
``swarm_tpu/aot/jitcache.py``.

The reference serializes XLA executables, one a (kernel, statics,
shapes) triple, behind a jit wrapper (``AotJit``) that makes the moment
of a new shape explicit. The port compiles per library, not per shape:
each CUDA library is built once from its sources and serves every
batch shape, so its artifact is the library file itself and the loader
(``ops/kernels.py`` ``load_library``) is the place where a fetch can
stand in for ``nvcc``.

A payload is ``_MAGIC``, then the library's name, its ``library_key``
(hex) and the sha256 (hex) of the library's bytes, each with its
length, then the bytes. :func:`load_payload` checks the header, that
the key equals this process's ``library_key(name)`` (its sources,
flags, ``nvcc --version`` and the card's capability), and the sha256;
only then does it write the bytes under ``library_path(name)``, through
a private file renamed into place as ``compile_library`` does, so a
concurrent loader never sees half a library. Any mismatch raises, and
nothing is written.
"""

from __future__ import annotations

import hashlib
import os
import threading
from pathlib import Path

from swarm_tpu_torch.ops import kernels

#: payload header, versioned so a wire change can never load stale bytes
_MAGIC = b"SWLIB1\x00"


def _field(out: bytearray, b: bytes) -> None:
    out += len(b).to_bytes(4, "little")
    out += b


def serialize_library(name: str) -> bytes:
    """Library ``name``'s keyed file → a payload (raises if the file is
    not there)."""
    data = kernels.library_path(name).read_bytes()
    out = bytearray(_MAGIC)
    for part in (name, kernels.library_key(name), hashlib.sha256(data).hexdigest()):
        _field(out, part.encode())
    out += data
    return bytes(out)


def decode_payload(blob: bytes) -> tuple[str, bytes]:
    """A payload → (library name, library bytes), checked: the header,
    a library this package builds, its key against this process's
    ``library_key`` and the bytes against their sha256. Raises
    ValueError on any mismatch."""
    if not blob.startswith(_MAGIC):
        raise ValueError("bad AOT artifact header")
    pos = len(_MAGIC)
    fields = []
    for _ in range(3):
        if pos + 4 > len(blob):
            raise ValueError("truncated AOT artifact")
        n = int.from_bytes(blob[pos:pos + 4], "little")
        pos += 4
        if pos + n > len(blob):
            raise ValueError("truncated AOT artifact")
        fields.append(blob[pos:pos + n].decode("ascii", "replace"))
        pos += n
    name, key, sha = fields
    if name not in kernels.LIBRARIES:
        raise ValueError(f"unknown library {name!r}")
    if key != kernels.library_key(name):
        raise ValueError(f"library {name} was built under another key")
    data = blob[pos:]
    if hashlib.sha256(data).hexdigest() != sha:
        raise ValueError(f"library {name}: sha256 mismatch")
    return name, data


def load_payload(blob: bytes) -> Path:
    """Check a payload (:func:`decode_payload`) and write its library
    under its keyed path → that path."""
    name, data = decode_payload(blob)
    lib_path = kernels.library_path(name)
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.parent / f".{lib_path.name}.{os.getpid()}.{threading.get_ident()}"
    tmp.write_bytes(data)
    os.replace(tmp, lib_path)
    return lib_path
