"""Pure-Python Avro: binary codec and object container files (the
port's own copy of ``photon_tpu/io/avro.py``).

The reference's model and data formats are Avro
(photon-avro-schemas/src/main/avro/*.avsc, AvroUtils.scala:62,
ModelProcessingUtils.scala:77) and no Avro library is installed. This is
the subset of the Avro 1.x specification those schemas need: the
primitives, records, arrays, maps, unions, enums, fixed and named-type
references, and the object container file (magic ``Obj\\x01``, a
metadata map with the schema JSON and codec, 16-byte sync markers, null
and deflate codecs). Its writes are byte for byte the JAX package's,
but for the sync marker, which each file draws from ``os.urandom``.

Container blocks decode through the native C decoder
(``photon_tpu_torch/native``) when it builds, else through the
interpreter codec below; ``DECODED_BLOCKS`` counts the blocks each
decoded in this process.
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib

MAGIC = b"Obj\x01"
# Container blocks decoded in this process, by decoder.
DECODED_BLOCKS = {"native": 0, "python": 0}
SYNC_SIZE = 16
_PRIMITIVES = {
    "null", "boolean", "int", "long", "float", "double", "bytes", "string"
}


class Schema:
    """Parsed Avro schema with a named-type registry for references."""

    def __init__(self, schema, names: dict | None = None):
        self.names: dict[str, dict] = {} if names is None else names
        self.root = self._parse(schema)

    def _parse(self, s):
        if isinstance(s, str):
            if s in _PRIMITIVES:
                return s
            if s in self.names:
                return self.names[s]
            raise ValueError(f"unknown type name {s!r}")
        if isinstance(s, list):  # union
            return [self._parse(b) for b in s]
        if isinstance(s, dict):
            t = s.get("type")
            if t in _PRIMITIVES and len(s) == 1:
                return t
            if t in ("record", "error"):
                out = {
                    "type": "record",
                    "name": s["name"],
                    "fields": [],
                }
                self._register(s, out)
                for f in s["fields"]:
                    out["fields"].append({
                        "name": f["name"],
                        "type": self._parse(f["type"]),
                        "default": f.get("default"),
                    })
                return out
            if t == "enum":
                out = {"type": "enum", "name": s["name"],
                       "symbols": list(s["symbols"])}
                self._register(s, out)
                return out
            if t == "fixed":
                out = {"type": "fixed", "name": s["name"],
                       "size": int(s["size"])}
                self._register(s, out)
                return out
            if t == "array":
                return {"type": "array", "items": self._parse(s["items"])}
            if t == "map":
                return {"type": "map", "values": self._parse(s["values"])}
            if isinstance(t, (dict, list)):
                return self._parse(t)
            if isinstance(t, str):
                return self._parse(t)
        raise ValueError(f"cannot parse schema fragment: {s!r}")

    def _register(self, raw, parsed):
        name = raw["name"]
        ns = raw.get("namespace")
        full = f"{ns}.{name}" if ns and "." not in name else name
        parsed["fullname"] = full
        self.names[full] = parsed
        self.names[name] = parsed


# --------------------------------------------------------------------------
# binary encoding
# --------------------------------------------------------------------------


def _write_long(buf: io.BytesIO, n: int) -> None:
    n = (n << 1) ^ (n >> 63)  # zigzag
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            buf.write(bytes([b | 0x80]))
        else:
            buf.write(bytes([b]))
            return


def _read_long(buf) -> int:
    shift = 0
    acc = 0
    while True:
        b = buf.read(1)
        if not b:
            raise EOFError("truncated varint")
        byte = b[0]
        acc |= (byte & 0x7F) << shift
        if not byte & 0x80:
            break
        shift += 7
    return (acc >> 1) ^ -(acc & 1)  # un-zigzag


def _read_exact(buf, n: int) -> bytes:
    data = buf.read(n)
    if len(data) != n:
        raise EOFError(f"truncated input: wanted {n} bytes, got {len(data)}")
    return data


def _encode(buf: io.BytesIO, schema, datum) -> None:
    if isinstance(schema, str):
        if schema == "null":
            return
        if schema == "boolean":
            buf.write(b"\x01" if datum else b"\x00")
        elif schema in ("int", "long"):
            _write_long(buf, int(datum))
        elif schema == "float":
            buf.write(struct.pack("<f", float(datum)))
        elif schema == "double":
            buf.write(struct.pack("<d", float(datum)))
        elif schema == "string":
            raw = datum.encode("utf-8")
            _write_long(buf, len(raw))
            buf.write(raw)
        elif schema == "bytes":
            _write_long(buf, len(datum))
            buf.write(datum)
        else:
            raise ValueError(f"bad primitive {schema!r}")
        return
    if isinstance(schema, list):  # union: pick first matching branch
        idx = _union_index(schema, datum)
        _write_long(buf, idx)
        _encode(buf, schema[idx], datum)
        return
    t = schema["type"]
    if t == "record":
        for f in schema["fields"]:
            name = f["name"]
            if isinstance(datum, dict) and name in datum:
                value = datum[name]
            else:
                value = f.get("default")
            _encode(buf, f["type"], value)
    elif t == "array":
        items = list(datum or ())
        if items:
            _write_long(buf, len(items))
            for it in items:
                _encode(buf, schema["items"], it)
        _write_long(buf, 0)
    elif t == "map":
        entries = dict(datum or {})
        if entries:
            _write_long(buf, len(entries))
            for k, v in entries.items():
                _encode(buf, "string", k)
                _encode(buf, schema["values"], v)
        _write_long(buf, 0)
    elif t == "enum":
        _write_long(buf, schema["symbols"].index(datum))
    elif t == "fixed":
        if len(datum) != schema["size"]:
            raise ValueError("fixed size mismatch")
        buf.write(datum)
    else:
        raise ValueError(f"bad schema type {t!r}")


def _union_index(branches, datum) -> int:
    for i, b in enumerate(branches):
        if _matches(b, datum):
            return i
    raise ValueError(f"datum {datum!r} matches no union branch")


def _matches(schema, datum) -> bool:
    if isinstance(schema, str):
        return {
            "null": datum is None,
            "boolean": isinstance(datum, bool),
            "int": (isinstance(datum, int) and not isinstance(datum, bool)
                    and -(2 ** 31) <= datum < 2 ** 31),
            "long": (isinstance(datum, int) and not isinstance(datum, bool)
                     and -(2 ** 63) <= datum < 2 ** 63),
            "float": (isinstance(datum, (float, int))
                      and not isinstance(datum, bool)),
            "double": isinstance(datum, (float, int)) and not isinstance(datum, bool),
            "string": isinstance(datum, str),
            "bytes": isinstance(datum, (bytes, bytearray)),
        }.get(schema, False)
    if isinstance(schema, list):
        return any(_matches(b, datum) for b in schema)
    t = schema["type"]
    if t == "record":
        return isinstance(datum, dict)
    if t == "array":
        return isinstance(datum, (list, tuple))
    if t == "map":
        return isinstance(datum, dict)
    if t == "enum":
        return isinstance(datum, str) and datum in schema["symbols"]
    if t == "fixed":
        return isinstance(datum, (bytes, bytearray))
    return False


def _decode(buf, schema):
    if isinstance(schema, str):
        if schema == "null":
            return None
        if schema == "boolean":
            return _read_exact(buf, 1) == b"\x01"
        if schema in ("int", "long"):
            return _read_long(buf)
        if schema == "float":
            return struct.unpack("<f", _read_exact(buf, 4))[0]
        if schema == "double":
            return struct.unpack("<d", _read_exact(buf, 8))[0]
        if schema == "string":
            n = _read_long(buf)
            return _read_exact(buf, n).decode("utf-8")
        if schema == "bytes":
            n = _read_long(buf)
            return _read_exact(buf, n)
        raise ValueError(f"bad primitive {schema!r}")
    if isinstance(schema, list):
        return _decode(buf, schema[_read_long(buf)])
    t = schema["type"]
    if t == "record":
        return {
            f["name"]: _decode(buf, f["type"]) for f in schema["fields"]
        }
    if t == "array":
        out = []
        while True:
            count = _read_long(buf)
            if count == 0:
                return out
            if count < 0:
                count = -count
                _read_long(buf)  # block byte size, unused
            for _ in range(count):
                out.append(_decode(buf, schema["items"]))
    if t == "map":
        out = {}
        while True:
            count = _read_long(buf)
            if count == 0:
                return out
            if count < 0:
                count = -count
                _read_long(buf)
            for _ in range(count):
                k = _decode(buf, "string")
                out[k] = _decode(buf, schema["values"])
    if t == "enum":
        return schema["symbols"][_read_long(buf)]
    if t == "fixed":
        return _read_exact(buf, schema["size"])
    raise ValueError(f"bad schema type {t!r}")


# --------------------------------------------------------------------------
# object container files
# --------------------------------------------------------------------------

_META_SCHEMA = {"type": "map", "values": "bytes"}


def write_container(
    path: str,
    schema_json: dict,
    records,
    *,
    codec: str = "deflate",
    sync_interval: int = 4000,
) -> None:
    """Write records to an Avro object container file."""
    schema = Schema(schema_json)
    sync = os.urandom(SYNC_SIZE)
    with open(path, "wb") as f:
        f.write(MAGIC)
        meta = io.BytesIO()
        _encode(meta, _META_SCHEMA, {
            "avro.schema": json.dumps(schema_json).encode(),
            "avro.codec": codec.encode(),
        })
        f.write(meta.getvalue())
        f.write(sync)

        block = io.BytesIO()
        count = 0

        def flush():
            nonlocal block, count
            if count == 0:
                return
            data = block.getvalue()
            if codec == "deflate":
                co = zlib.compressobj(wbits=-15)  # raw deflate stream
                data = co.compress(data) + co.flush()
            elif codec != "null":
                raise ValueError(f"unsupported codec {codec!r}")
            head = io.BytesIO()
            _write_long(head, count)
            _write_long(head, len(data))
            f.write(head.getvalue())
            f.write(data)
            f.write(sync)
            block = io.BytesIO()
            count = 0

        for rec in records:
            _encode(block, schema.root, rec)
            count += 1
            if count >= sync_interval:
                flush()
        flush()


_PROGRAM_OPS = {
    "null": 0, "boolean": 1, "int": 2, "long": 2,
    "float": 3, "double": 4, "string": 5, "bytes": 6,
}


def schema_to_program(node, _stack=None):
    """Compile a parsed schema node into the native decoder's opcode tree
    (photon_tpu_torch/native/avrodec.c documents the encoding). Returns None for
    shapes the native decoder does not handle (recursive types) — callers
    fall back to the interpreter codec."""
    if isinstance(node, str):
        return (_PROGRAM_OPS[node],)
    if isinstance(node, list):
        branches = tuple(
            schema_to_program(b, _stack) for b in node
        )
        if any(b is None for b in branches):
            return None
        return (10, branches)
    stack = _stack if _stack is not None else set()
    key = id(node)
    if key in stack:
        return None  # recursive type: interpreter fallback
    stack.add(key)
    try:
        t = node["type"]
        if t == "record":
            names = tuple(f["name"] for f in node["fields"])
            progs = tuple(
                schema_to_program(f["type"], stack) for f in node["fields"]
            )
            if any(p is None for p in progs):
                return None
            return (7, names, progs)
        if t == "array":
            item = schema_to_program(node["items"], stack)
            return None if item is None else (8, item)
        if t == "map":
            val = schema_to_program(node["values"], stack)
            return None if val is None else (9, val)
        if t == "enum":
            return (11, tuple(node["symbols"]))
        if t == "fixed":
            return (12, int(node["size"]))
        return None
    finally:
        stack.discard(key)


def _decode_blocks(blocks):
    """Record stream over (schema_json, count, payload_bytes) blocks —
    the shared decode dispatch of the path- and bytes-based container
    iterators (native C decoder when available, interpreter fallback)."""
    from photon_tpu_torch.native import get_avro_decoder

    schema = program = native = None
    for schema_json, count, data in blocks:
        if schema is None:
            schema = Schema(schema_json)
            program = schema_to_program(schema.root)
            native = get_avro_decoder() if program is not None else None
        if native is not None:
            DECODED_BLOCKS["native"] += 1
            yield from native.decode_block(data, count, program)
        else:
            DECODED_BLOCKS["python"] += 1
            block = io.BytesIO(data)
            for _ in range(count):
                yield _decode(block, schema.root)


def iter_container(path: str):
    """Stream an Avro object container file block by block.

    Generator of decoded records: at any moment only ONE decompressed block
    (``sync_interval`` records, default 4000) of Python dicts is alive —
    the O(batch) decode the ingest pipeline builds its arrays from. The
    file handle closes when the generator is exhausted or dropped.

    Blocks decode through the native C decoder when it is available
    (photon_tpu_torch/native, ~40x the interpreter codec); the interpreter path
    remains the behavioral reference and the fallback.
    """
    yield from _decode_blocks(iter_container_block_bytes(path))


def iter_container_bytes(data: bytes, *, name: str = "<bytes>"):
    """Stream records from an IN-MEMORY Avro container.

    The streaming ingest's read-once path: the shard's bytes are read
    from disk a single time (hashed for the integrity manifest), then
    decoded from the same buffer — no second disk pass, and no TOCTOU
    window between the checksum and the decode. ``name`` labels parse
    errors the way a path would.
    """
    yield from _decode_blocks(_iter_blocks(io.BytesIO(data), name))


def iter_container_block_bytes(path: str):
    """Yield (schema_json, count, payload_bytes) per container block.

    ``payload_bytes`` is the decompressed record stream of the block — the
    concatenated binary encodings of ``count`` records. Golden write-parity
    tests re-encode decoded records and compare against this byte stream.
    """
    with open(path, "rb") as f:
        yield from _iter_blocks(f, path)


def _iter_blocks(f, label: str):
    if f.read(4) != MAGIC:
        raise ValueError(f"{label}: not an Avro container file")
    meta = _decode(f, _META_SCHEMA)
    schema_json = json.loads(meta["avro.schema"].decode())
    codec = meta.get("avro.codec", b"null").decode()
    sync = f.read(SYNC_SIZE)
    while True:
        try:
            count = _read_long(f)
        except EOFError:
            break
        size = _read_long(f)
        data = f.read(size)
        if codec == "deflate":
            data = zlib.decompress(data, wbits=-15)
        elif codec != "null":
            raise ValueError(f"unsupported codec {codec!r}")
        yield schema_json, count, data
        if f.read(SYNC_SIZE) != sync:
            raise ValueError(f"{label}: sync marker mismatch")


def encode_records(schema_json: dict, records) -> bytes:
    """Binary-encode ``records`` under ``schema_json`` (no container
    framing) — the record-body byte stream a container block holds."""
    schema = Schema(schema_json)
    buf = io.BytesIO()
    for rec in records:
        _encode(buf, schema.root, rec)
    return buf.getvalue()


# --- Parsing Canonical Form + CRC-64-AVRO fingerprint (Avro spec) --------

_CANONICAL_PRIMITIVES = {
    "null", "boolean", "int", "long", "float", "double", "bytes", "string",
}


def parsing_canonical_form(schema, namespace: str | None = None) -> str:
    """The Avro Parsing Canonical Form of a schema (spec section
    "Transforming into Parsing Canonical Form"): fullnames, attribute
    stripping ([STRIP] doc/aliases/defaults), fixed field order, minimal
    JSON. Two schemas with equal canonical form decode identically."""
    return _pcf(schema, namespace)


def _pcf(node, ns):
    if isinstance(node, str):
        if node in _CANONICAL_PRIMITIVES:
            return f'"{node}"'
        full = node if "." in node or not ns else f"{ns}.{node}"
        return f'"{full}"'
    if isinstance(node, list):
        return "[" + ",".join(_pcf(b, ns) for b in node) + "]"
    t = node["type"]
    if isinstance(t, (dict, list)) or (
        t not in _CANONICAL_PRIMITIVES
        and t not in ("record", "enum", "array", "map", "fixed")
    ):
        # {"type": <nested schema>} wrapper
        return _pcf(t, ns)
    if t in _CANONICAL_PRIMITIVES:
        return f'"{t}"'
    if t in ("record", "enum", "fixed"):
        name = node["name"]
        if "." in name:
            full = name
            child_ns = name.rsplit(".", 1)[0]
        else:
            child_ns = node.get("namespace", ns)
            full = f"{child_ns}.{name}" if child_ns else name
        parts = [f'"name":"{full}"', f'"type":"{t}"']
        if t == "record":
            fields = ",".join(
                "{" + f'"name":"{f["name"]}"'
                + f',"type":{_pcf(f["type"], child_ns)}' + "}"
                for f in node["fields"]
            )
            parts.append(f'"fields":[{fields}]')
        elif t == "enum":
            syms = ",".join(f'"{s}"' for s in node["symbols"])
            parts.append(f'"symbols":[{syms}]')
        else:
            parts.append(f'"size":{int(node["size"])}')
        return "{" + ",".join(parts) + "}"
    if t == "array":
        return '{"type":"array","items":' + _pcf(node["items"], ns) + "}"
    if t == "map":
        return '{"type":"map","values":' + _pcf(node["values"], ns) + "}"
    raise ValueError(f"bad schema node {node!r}")


_CRC64_EMPTY = 0xC15D213AA4D7A795
_crc64_table: list | None = None


def schema_fingerprint(schema, namespace: str | None = None) -> int:
    """CRC-64-AVRO fingerprint of the Parsing Canonical Form (Avro spec)."""
    global _crc64_table
    if _crc64_table is None:
        table = []
        for i in range(256):
            fp = i
            for _ in range(8):
                fp = (fp >> 1) ^ (_CRC64_EMPTY & -(fp & 1))
            table.append(fp & 0xFFFFFFFFFFFFFFFF)
        _crc64_table = table
    fp = _CRC64_EMPTY
    for b in parsing_canonical_form(schema, namespace).encode("utf-8"):
        fp = (fp >> 8) ^ _crc64_table[(fp ^ b) & 0xFF]
    return fp


def iter_container_dir(path: str):
    """Stream all part files of a file-or-directory of Avro containers
    (the HDFS part-* layout of AvroUtils.readAvroFiles)."""
    if os.path.isfile(path):
        yield from iter_container(path)
        return
    for name in sorted(os.listdir(path)):
        if name.endswith(".avro"):
            yield from iter_container(os.path.join(path, name))


def container_schema(path: str) -> dict:
    """Read just the schema of a container file (no record decode)."""
    with open(path, "rb") as f:
        if f.read(4) != MAGIC:
            raise ValueError(f"{path}: not an Avro container file")
        meta = _decode(f, _META_SCHEMA)
        return json.loads(meta["avro.schema"].decode())


def read_container(path: str) -> tuple[dict, list]:
    """Read an Avro object container file -> (schema_json, records)."""
    return container_schema(path), list(iter_container(path))


def read_container_dir(path: str) -> list:
    """Read all part files of a directory of Avro containers, materialized.
    Prefer ``iter_container_dir`` for large inputs."""
    return list(iter_container_dir(path))
