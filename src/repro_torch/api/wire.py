"""SPDC wire format — the serializable face of the role-split API (port
of repro.api.wire; frames are byte-identical to the reference's for the
same scalars and numpy arrays).

Every message that crosses the client ↔ edge-server trust boundary
(ShardTask, ShardResult) or is archived/relayed by infrastructure
(Verdict, Determinant) encodes to a self-describing byte frame:

    ┌──────┬─────┬──────────────┬─────────────────┬───────────────────┐
    │ SPDC │ ver │ header nbytes│ header (JSON)    │ array buffers …   │
    │ 4 B  │ 1 B │ u32 big-end. │ utf-8            │ 16-byte aligned   │
    └──────┴─────┴──────────────┴─────────────────┴───────────────────┘

The JSON header carries the message kind, every scalar field (ints,
floats, bools, strings, None), `bytes` fields hex-encoded, and an array
table — one entry per ndarray payload with dtype/shape/offset — whose raw
little-endian buffers follow the header, each padded to a 16-byte offset
so zero-copy `np.frombuffer` views stay aligned.

Design constraints (why not pickle):

  * messages cross a TRUST boundary — the client must be able to decode a
    ShardResult from a malicious server without executing anything, and a
    server must decode ShardTasks without trusting the client. JSON +
    fixed dtype/shape tables are data, never code.
  * the format is language-agnostic and versioned (`VERSION` byte), so a
    non-Python edge worker can speak it.
  * floats in array payloads round-trip bit-exactly (raw IEEE buffers);
    scalar floats ride through JSON `repr` (shortest round-trip in
    Python ≥ 3.1) — also exact.

`encode(kind, scalars, arrays)` / `decode(data)` are the primitive pair;
message classes register themselves in `MESSAGE_KINDS` so
`decode_message(data)` can dispatch a frame of any known kind (the
transports' receive loop). Tensors are turned into host numpy arrays
by the message classes before they reach `encode`.
"""
from __future__ import annotations

import json
import struct

import numpy as np

MAGIC = b"SPDC"
VERSION = 1
_ALIGN = 16

#: kind (str) -> class with a `_from_wire(scalars, arrays)` classmethod;
#: populated by each message module at import time (see register()).
MESSAGE_KINDS: dict[str, type] = {}


class WireError(ValueError):
    """Malformed, truncated, or unknown-kind frame."""


def register(kind: str):
    """Class decorator: make `decode_message` able to dispatch `kind`."""

    def deco(cls):
        MESSAGE_KINDS[kind] = cls
        cls.wire_kind = kind
        return cls

    return deco


def _pad(offset: int) -> int:
    return (offset + _ALIGN - 1) // _ALIGN * _ALIGN


def encode(kind: str, scalars: dict, arrays: dict) -> bytes:
    """Encode one frame. `scalars` values must be JSON-able or bytes;
    `arrays` values are ndarrays (or None, recorded as absent-but-named so
    decode restores the None)."""
    header: dict = {"kind": kind, "scalars": {}, "bytes": {}, "arrays": []}
    for name, val in scalars.items():
        if isinstance(val, bytes):
            header["bytes"][name] = val.hex()
        elif isinstance(val, float):
            # repr round-trips IEEE-754 doubles exactly; JSON numbers may
            # be re-formatted by other emitters, so pin the string form
            header["scalars"][name] = {"__float__": repr(val)}
        else:
            header["scalars"][name] = val
    buffers: list[tuple[int, bytes]] = []
    offset = 0
    for name, arr in arrays.items():
        if arr is None:
            header["arrays"].append({"name": name, "none": True})
            continue
        arr = np.ascontiguousarray(arr)
        if arr.dtype.byteorder == ">":  # normalize to little-endian wire
            arr = arr.astype(arr.dtype.newbyteorder("<"))
        offset = _pad(offset)
        raw = arr.tobytes()
        header["arrays"].append(
            {
                "name": name,
                "dtype": arr.dtype.str,
                "shape": list(arr.shape),
                "offset": offset,
                "nbytes": len(raw),
            }
        )
        buffers.append((offset, raw))
        offset += len(raw)
    hjson = json.dumps(header, separators=(",", ":")).encode()
    head = MAGIC + struct.pack(">BI", VERSION, len(hjson)) + hjson
    body_start = _pad(len(head))
    out = bytearray(body_start + offset)
    out[: len(head)] = head
    for off, raw in buffers:
        out[body_start + off : body_start + off + len(raw)] = raw
    return bytes(out)


def decode(data: bytes) -> tuple[str, dict, dict]:
    """Decode one frame → (kind, scalars, arrays). bytes fields come back
    as bytes; None arrays come back as None; float scalars bit-exact."""
    if len(data) < len(MAGIC) + 5 or data[: len(MAGIC)] != MAGIC:
        raise WireError("not an SPDC wire frame (bad magic)")
    version, hlen = struct.unpack_from(">BI", data, len(MAGIC))
    if version != VERSION:
        raise WireError(f"unsupported wire version {version}")
    hstart = len(MAGIC) + 5
    if len(data) < hstart + hlen:
        raise WireError("truncated frame (header)")
    try:
        header = json.loads(data[hstart : hstart + hlen].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireError(f"bad frame header: {e}") from e
    scalars = {}
    for name, val in header.get("scalars", {}).items():
        if isinstance(val, dict) and "__float__" in val:
            val = float(val["__float__"])
        scalars[name] = val
    for name, hexval in header.get("bytes", {}).items():
        scalars[name] = bytes.fromhex(hexval)
    body_start = _pad(hstart + hlen)
    arrays = {}
    for spec in header.get("arrays", []):
        name = spec.get("name")
        if spec.get("none"):
            arrays[name] = None
            continue
        # every header-supplied field is attacker-controlled: a frame from
        # a malicious server must either decode to exactly what a wellformed
        # encoder produced or raise WireError — never reinterpret header
        # bytes (negative offsets), object dtypes, or impossible shapes
        try:
            offset, nbytes = int(spec["offset"]), int(spec["nbytes"])
            shape = tuple(int(s) for s in spec["shape"])
            dtype = np.dtype(spec["dtype"])
        except (KeyError, TypeError, ValueError) as e:
            raise WireError(f"bad array spec for {name!r}: {e}") from e
        if dtype.hasobject:
            raise WireError(f"non-plain dtype {dtype} in array {name!r}")
        if offset < 0 or nbytes < 0 or any(s < 0 for s in shape):
            raise WireError(f"negative offset/size in array {name!r}")
        start = body_start + offset
        end = start + nbytes
        if end > len(data):
            raise WireError(f"truncated frame (array {name!r})")
        try:
            arr = np.frombuffer(data[start:end], dtype=dtype).reshape(shape)
        except ValueError as e:
            raise WireError(f"array {name!r} does not decode: {e}") from e
        arrays[name] = arr
    return header["kind"], scalars, arrays


def decode_message(data: bytes):
    """Decode a frame of any registered kind into its message object."""
    kind, scalars, arrays = decode(data)
    cls = MESSAGE_KINDS.get(kind)
    if cls is None:
        raise WireError(
            f"unknown message kind {kind!r}; known: {sorted(MESSAGE_KINDS)}"
        )
    return cls._from_wire(scalars, arrays)
