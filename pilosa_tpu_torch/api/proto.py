"""Protobuf wire codec for the query and import endpoints
(``pilosa_tpu.api.proto``, the port's own copy): the same messages,
byte for byte, hand-rolled on ``struct``: varints, zigzag sint64, 64-bit
doubles, length-delimited submessages and packed repeated scalars.

Encoding maps the JSON result shapes of
:func:`pilosa_tpu_torch.exec.result_to_json`: the server converts at the
HTTP edge, so the executor stays JSON-native.  Column and row ids are
uint64 varints and BSI values zigzag sint64, whatever dtype the caller's
arrays carry.
"""

from __future__ import annotations

import struct

# wire types
_VARINT, _I64, _LEN = 0, 1, 2

CONTENT_TYPE = "application/x-protobuf"


def _malformed_as_value_error(fn):
    """Decoders promise ValueError on ANY malformed input (the HTTP and
    gRPC layers translate that into decodable 400s / .err responses) —
    but the raw parsing raises struct.error on short fixed-width
    payloads, AttributeError on wire-type confusion (int where bytes
    expected), and UnicodeDecodeError on bad UTF-8."""
    import functools
    import struct as _struct

    @functools.wraps(fn)
    def wrapped(buf):
        try:
            return fn(buf)
        except (ValueError, _struct.error, AttributeError,
                UnicodeDecodeError, TypeError, IndexError) as e:
            if type(e) is ValueError:
                raise
            raise ValueError(f"proto: malformed message: {e}")
    return wrapped


# -- primitives --------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63) if n < 0 else n << 1


def _unzigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _uint(field: int, n: int) -> bytes:
    return _tag(field, _VARINT) + _varint(int(n)) if n else b""


def _string(field: int, s: str) -> bytes:
    if not s:
        return b""
    raw = s.encode()
    return _tag(field, _LEN) + _varint(len(raw)) + raw


def _strings(field: int, items, what: str) -> bytes:
    """Repeated string ``field`` (one join: appending to a growing bytes
    object per item is quadratic); an empty item is refused, since an
    empty string elides and would desync the parallel arrays."""
    parts = []
    for s in items:
        if not s:
            raise ValueError(f"proto: empty {what}")
        parts.append(_string(field, s))
    return b"".join(parts)


def _sub(field: int, raw: bytes) -> bytes:
    return _tag(field, _LEN) + _varint(len(raw)) + raw


def _vec_varints(values) -> bytes:
    """Packed varint body for a uint64 array, vectorized: per-value
    byte lengths by comparison ladder, then one numpy pass per varint
    byte position.  A Python per-int loop measured 7× slower than
    C-json on 100k-id import batches — the packed arrays ARE the wire,
    so this is the codec's hot path."""
    import numpy as _np
    try:
        v = _np.asarray(values, dtype=_np.uint64)
    except OverflowError as e:
        raise ValueError(f"proto: value out of uint64 range: {e}")
    lens = _np.ones(len(v), _np.int64)
    for g in range(1, 10):
        lens += (v >= (_np.uint64(1) << _np.uint64(7 * g)))
    offs = _np.cumsum(lens) - lens
    out = _np.zeros(int(lens.sum()), _np.uint8)
    for g in range(10):
        m = lens > g
        if not m.any():
            break
        byte = ((v[m] >> _np.uint64(7 * g))
                & _np.uint64(0x7F)).astype(_np.uint8)
        out[offs[m] + g] = byte | _np.where(lens[m] > g + 1, 0x80,
                                            0).astype(_np.uint8)
    return out.tobytes()


def _vec_zigzag(values):
    """int64 list/array -> zigzagged uint64 array (vectorized).
    Out-of-int64 inputs raise ValueError (not numpy's OverflowError),
    so callers' fall-back-to-JSON handling fires."""
    import numpy as _np
    try:
        v = _np.asarray(values, dtype=_np.int64)
    except OverflowError as e:
        raise ValueError(f"proto: value out of sint64 range: {e}")
    return ((v << 1) ^ (v >> 63)).view(_np.uint64)


def _packed(field: int, values, enc) -> bytes:
    if not len(values):
        return b""
    if enc is _varint:
        raw = _vec_varints(values)
    else:
        raw = b"".join(enc(int(v)) for v in values)
    return _tag(field, _LEN) + _varint(len(raw)) + raw


def _double(field: int, v: float) -> bytes:
    return _tag(field, _I64) + struct.pack("<d", v)


class _Reader:
    def __init__(self, buf: bytes):
        self.buf, self.pos = buf, 0

    def varint(self) -> int:
        n = shift = 0
        while True:
            if self.pos >= len(self.buf):
                raise ValueError("proto: truncated varint")
            b = self.buf[self.pos]
            self.pos += 1
            n |= (b & 0x7F) << shift
            if not b & 0x80:
                return n
            shift += 7
            if shift > 70:
                raise ValueError("proto: varint too long")

    def fields(self):
        """Yield (field, wire, value) — value is int for varint, bytes
        for length-delimited, 8 raw bytes for i64."""
        while self.pos < len(self.buf):
            key = self.varint()
            field, wire = key >> 3, key & 7
            if wire == _VARINT:
                yield field, wire, self.varint()
            elif wire == _LEN:
                n = self.varint()
                if self.pos + n > len(self.buf):
                    raise ValueError("proto: truncated field")
                yield field, wire, self.buf[self.pos:self.pos + n]
                self.pos += n
            elif wire == _I64:
                if self.pos + 8 > len(self.buf):
                    raise ValueError("proto: truncated i64")
                yield field, wire, self.buf[self.pos:self.pos + 8]
                self.pos += 8
            elif wire == 5:  # i32
                self.pos += 4
            else:
                raise ValueError(f"proto: unsupported wire type {wire}")


def _packed_uints(raw) -> list[int]:
    if isinstance(raw, int):  # unpacked single element
        return [raw]
    if not len(raw):
        return []
    # vectorized: varint boundaries are the bytes without the
    # continuation bit; one numpy pass per byte position reconstructs
    # every value (counterpart of _vec_varints)
    import numpy as _np
    buf = _np.frombuffer(raw, _np.uint8)
    ends = _np.nonzero((buf & 0x80) == 0)[0]
    if not len(ends) or int(ends[-1]) != len(buf) - 1:
        raise ValueError("proto: truncated packed varint")
    starts = _np.concatenate(([0], ends[:-1] + 1))
    lens = ends - starts + 1
    if int(lens.max()) > 10:
        raise ValueError("proto: varint too long")
    vals = _np.zeros(len(starts), _np.uint64)
    for g in range(int(lens.max())):
        m = lens > g
        vals[m] |= ((buf[starts[m] + g] & _np.uint8(0x7F))
                    .astype(_np.uint64) << _np.uint64(7 * g))
    return vals.tolist()


# -- QueryRequest ------------------------------------------------------------


@_malformed_as_value_error
def decode_query_request(buf: bytes) -> tuple[str, list[int] | None]:
    """-> (pql, shards or None)."""
    pql, shards = "", None
    for field, wire, val in _Reader(buf).fields():
        if field == 1 and wire == _LEN:
            pql = val.decode()
        elif field == 2:
            shards = (shards or []) + _packed_uints(val)
    return pql, shards


@_malformed_as_value_error
def decode_query_request_indexed(buf: bytes) \
        -> tuple[str, list[int] | None, str]:
    """-> (pql, shards or None, index) — the gRPC form, where no URL
    path carries the index name.  One pass over the buffer."""
    pql, index = "", ""
    shards = None
    for field, wire, val in _Reader(buf).fields():
        if field == 1 and wire == _LEN:
            pql = val.decode()
        elif field == 2:
            shards = (shards or []) + _packed_uints(val)
        elif field == 3 and wire == _LEN:
            index = val.decode()
    return pql, shards, index


def encode_query_request(pql: str, shards=None, index: str = "") -> bytes:
    out = _string(1, pql)
    if shards:
        out += _packed(2, shards, _varint)
    out += _string(3, index)
    return out


# -- Import requests ---------------------------------------------------------


def encode_import_request(*, index: str = "", field: str = "",
                          row_ids=None, col_ids=None, row_keys=None,
                          col_keys=None, timestamps=None,
                          clear: bool = False) -> bytes:
    """ImportRequest bytes.  ``timestamps`` must be homogeneous — all
    epoch ints or all ISO strings; a mixed list raises ValueError (the
    caller falls back to the JSON wire, which allows heterogeneity)."""
    out = _string(1, index) + _string(2, field)
    if row_ids is not None and len(row_ids):
        out += _packed(3, row_ids, _varint)
    if col_ids is not None and len(col_ids):
        out += _packed(4, col_ids, _varint)
    # empty strings are unrepresentable on this wire (zero-valued
    # fields elide — an empty key would silently vanish and desync the
    # parallel arrays): refuse so callers' JSON fallback fires
    out += _strings(5, row_keys or [], "row key")
    out += _strings(6, col_keys or [], "column key")
    if timestamps is not None and len(timestamps):
        if all(isinstance(t, int) for t in timestamps):
            out += _packed(7, _vec_zigzag([int(t) for t in timestamps]),
                           _varint)
        elif all(isinstance(t, str) for t in timestamps):
            out += _strings(9, timestamps, "timestamp")
        else:
            raise ValueError("proto: mixed timestamp types")
    if clear:
        out += _uint(8, 1)
    return out


@_malformed_as_value_error
def decode_import_request(buf: bytes) -> dict:
    """-> kwargs-shaped dict (row_ids/col_ids/row_keys/col_keys/
    timestamps/clear/index/field); absent lists are None."""
    index = field_name = ""
    row_ids: list | None = None
    col_ids: list | None = None
    row_keys: list | None = None
    col_keys: list | None = None
    ts: list | None = None
    clear = False
    for field, wire, val in _Reader(buf).fields():
        if field == 1:
            index = val.decode()
        elif field == 2:
            field_name = val.decode()
        elif field == 3:
            row_ids = (row_ids or []) + _packed_uints(val)
        elif field == 4:
            col_ids = (col_ids or []) + _packed_uints(val)
        elif field == 5:
            row_keys = row_keys if row_keys is not None else []
            row_keys.append(val.decode())
        elif field == 6:
            col_keys = col_keys if col_keys is not None else []
            col_keys.append(val.decode())
        elif field == 7:
            ts = (ts or []) + [_unzigzag(v) for v in _packed_uints(val)]
        elif field == 8:
            clear = bool(val)
        elif field == 9:
            ts = ts if ts is not None else []
            ts.append(val.decode())
    return {"index": index, "field": field_name, "row_ids": row_ids,
            "col_ids": col_ids, "row_keys": row_keys,
            "col_keys": col_keys, "timestamps": ts, "clear": clear}


def encode_import_value_request(*, index: str = "", field: str = "",
                                col_ids=None, col_keys=None,
                                values=None) -> bytes:
    out = _string(1, index) + _string(2, field)
    if col_ids is not None and len(col_ids):
        out += _packed(3, col_ids, _varint)
    # see encode_import_request: empty strings elide
    out += _strings(4, col_keys or [], "column key")
    vals = values if values is not None else []
    if len(vals):
        if all(isinstance(v, bool) for v in vals):
            raise ValueError("proto: bool import values")
        if all(isinstance(v, int) for v in vals):
            out += _packed(5, _vec_zigzag([int(v) for v in vals]), _varint)
        elif all(isinstance(v, (int, float)) for v in vals):
            # mixed ints encode as float64: refuse ints the double
            # can't carry exactly (|v| > 2^53) — silent rounding is
            # data corruption, the JSON fallback carries them intact
            for v in vals:
                if isinstance(v, int):
                    try:
                        exact = int(float(v)) == v
                    except OverflowError:
                        exact = False
                    if not exact:
                        raise ValueError(
                            f"proto: int {v} not exact in float64")
            raw = b"".join(struct.pack("<d", float(v)) for v in vals)
            out += _tag(6, _LEN) + _varint(len(raw)) + raw
        elif all(isinstance(v, str) for v in vals):
            out += _strings(7, vals, "value string")
        else:
            raise ValueError("proto: mixed import value types")
    return out


@_malformed_as_value_error
def decode_import_value_request(buf: bytes) -> dict:
    index = field_name = ""
    col_ids: list | None = None
    col_keys: list | None = None
    values: list | None = None
    for field, wire, val in _Reader(buf).fields():
        if field == 1:
            index = val.decode()
        elif field == 2:
            field_name = val.decode()
        elif field == 3:
            col_ids = (col_ids or []) + _packed_uints(val)
        elif field == 4:
            col_keys = col_keys if col_keys is not None else []
            col_keys.append(val.decode())
        elif field == 5:
            values = (values or []) + [_unzigzag(v)
                                       for v in _packed_uints(val)]
        elif field == 6:
            values = (values or []) + list(
                struct.unpack(f"<{len(val) // 8}d", val))
        elif field == 7:
            values = values if values is not None else []
            values.append(val.decode())
    return {"index": index, "field": field_name, "col_ids": col_ids,
            "col_keys": col_keys, "values": values}


def encode_import_response(changed: int = 0, err: str = "") -> bytes:
    out = b""
    if changed:
        out += _tag(1, _VARINT) + _varint(_zigzag(int(changed)))
    return out + _string(2, err)


@_malformed_as_value_error
def decode_import_response(buf: bytes) -> dict:
    changed, err = 0, ""
    for field, wire, val in _Reader(buf).fields():
        if field == 1:
            changed = _unzigzag(val)
        elif field == 2:
            err = val.decode()
    out = {"changed": changed}
    if err:
        out["error"] = err
    return out


# -- QueryResponse -----------------------------------------------------------

T_NIL, T_ROW, T_PAIRS, T_VALCOUNT, T_COUNT, T_BOOL, T_ROWIDS, \
    T_GROUPS, T_DISTINCT = range(9)


def _enc_valcount(v) -> bytes:
    out = b""
    val = v.get("value", 0)
    if isinstance(val, float):
        out += _double(3, val) + _uint(4, 1)
    else:
        out += _tag(1, _VARINT) + _varint(_zigzag(int(val)))
    out += _tag(2, _VARINT) + _varint(_zigzag(int(v.get("count", 0))))
    return out


def _enc_result(r) -> bytes:
    if r is None:
        return _uint(1, T_NIL)
    if isinstance(r, bool):
        return _uint(1, T_BOOL) + _uint(4, int(r))
    if isinstance(r, int):
        return _uint(1, T_COUNT) + _uint(3, r)
    if isinstance(r, list):  # TopN pairs or GroupBy groups
        if r and "group" in r[0]:
            out = [_uint(1, T_GROUPS)]
            for g in r:
                sub = b""
                for fr in g["group"]:
                    frb = _string(1, fr["field"])
                    if "rowKey" in fr:
                        frb += _string(3, fr["rowKey"])
                    else:
                        frb += _uint(2, fr.get("rowID", 0))
                    sub += _sub(1, frb)
                sub += _uint(2, g.get("count", 0))
                if g.get("agg") is not None:
                    sub += _tag(3, _VARINT) + _varint(_zigzag(int(g["agg"])))
                    sub += _uint(4, 1)
                out.append(_sub(9, sub))
            return b"".join(out)
        out = [_uint(1, T_PAIRS)]
        for p in r:
            sub = _uint(2, p.get("count", 0))
            if "key" in p:
                sub += _string(3, p["key"])
            else:
                sub += _uint(1, p.get("id", 0))
            out.append(_sub(5, sub))
        return b"".join(out)
    if isinstance(r, dict):
        if "fields" in r:  # Extract: tabular, no proto representation
            raise ValueError(
                "Extract results are not representable in the protobuf "
                "schema; request JSON")
        keyed = ("keys" in r and "rows" not in r
                 and "value" not in r and "values" not in r)
        if "columns" in r or keyed:
            sub = _packed(1, r.get("columns", []), _varint)
            sub += b"".join(_string(2, k) for k in r.get("keys", []) or [])
            if keyed:  # explicit flag so {"keys": []} round-trips
                sub += _uint(3, 1)
            if r.get("rowAttrs") or r.get("attrs"):
                import json as _json
                if r.get("rowAttrs"):
                    sub += _string(4, _json.dumps(r["rowAttrs"]))
                if r.get("attrs"):
                    sub += _string(5, _json.dumps(r["attrs"]))
            return _uint(1, T_ROW) + _sub(2, sub)
        if "rows" in r:
            return _uint(1, T_ROWIDS) + _packed(7, r["rows"], _varint)
        if "value" in r:
            return _uint(1, T_VALCOUNT) + _sub(6, _enc_valcount(r))
        if "values" in r:
            out = _uint(1, T_DISTINCT)
            vals = r["values"]
            if any(isinstance(v, float) for v in vals):
                raw = b"".join(struct.pack("<d", float(v)) for v in vals)
                return out + (_tag(11, _LEN) + _varint(len(raw)) + raw
                              if raw else b"")
            return out + _packed(10, _vec_zigzag([int(v) for v in vals]),
                                 _varint)
    raise ValueError(f"proto: unencodable result {type(r)}")


def encode_query_response(results=None, err: str = "") -> bytes:
    return _string(1, err) + b"".join(_sub(2, _enc_result(r))
                                      for r in results or [])


# -- response decode (client/test side) --------------------------------------


def _dec_valcount(raw: bytes) -> dict:
    out = {"value": 0, "count": 0}
    is_float, fval = False, 0.0
    for field, wire, val in _Reader(raw).fields():
        if field == 1:
            out["value"] = _unzigzag(val)
        elif field == 2:
            out["count"] = _unzigzag(val)
        elif field == 3:
            fval = struct.unpack("<d", val)[0]
        elif field == 4:
            is_float = bool(val)
    if is_float:
        out["value"] = fval
    return out


def _dec_result(raw: bytes):
    typ = 0
    row_cols, row_keys = [], []
    row_keyed = False
    row_attrs = None
    col_attrs = None
    n = 0
    changed = False
    pairs, groups, row_ids, values = [], [], [], []
    valcount = None
    for field, wire, val in _Reader(raw).fields():
        if field == 1:
            typ = val
        elif field == 2:  # Row
            for f2, w2, v2 in _Reader(val).fields():
                if f2 == 1:
                    row_cols += _packed_uints(v2)
                elif f2 == 2:
                    row_keys.append(v2.decode())
                elif f2 == 3:
                    row_keyed = bool(v2)
                elif f2 == 4:
                    import json as _json
                    row_attrs = _json.loads(v2.decode())
                elif f2 == 5:
                    import json as _json
                    col_attrs = _json.loads(v2.decode())
        elif field == 3:
            n = val
        elif field == 4:
            changed = bool(val)
        elif field == 5:  # Pair
            p = {}
            for f2, w2, v2 in _Reader(val).fields():
                if f2 == 1:
                    p["id"] = v2
                elif f2 == 2:
                    p["count"] = v2
                elif f2 == 3:
                    p["key"] = v2.decode()
            p.setdefault("count", 0)
            if "key" not in p:
                p.setdefault("id", 0)
            pairs.append(p)
        elif field == 6:
            valcount = _dec_valcount(val)
        elif field == 7:
            row_ids += _packed_uints(val)
        elif field == 9:  # GroupCount
            g = {"group": [], "count": 0}
            has_agg = False
            for f2, w2, v2 in _Reader(val).fields():
                if f2 == 1:
                    fr = {}
                    for f3, w3, v3 in _Reader(v2).fields():
                        if f3 == 1:
                            fr["field"] = v3.decode()
                        elif f3 == 2:
                            fr["rowID"] = v3
                        elif f3 == 3:
                            fr["rowKey"] = v3.decode()
                    if "rowKey" not in fr:
                        fr.setdefault("rowID", 0)
                    g["group"].append(fr)
                elif f2 == 2:
                    g["count"] = v2
                elif f2 == 3:
                    g["agg"] = _unzigzag(v2)
                elif f2 == 4:
                    has_agg = bool(v2)
            if not has_agg:
                g.pop("agg", None)
            groups.append(g)
        elif field == 10:
            values += [_unzigzag(v) for v in _packed_uints(val)]
        elif field == 11:
            values += list(struct.unpack(f"<{len(val) // 8}d", val))
    if typ == T_NIL:
        return None
    if typ == T_BOOL:
        return changed
    if typ == T_COUNT:
        return n
    if typ == T_ROW:
        out = ({"keys": row_keys} if row_keyed or row_keys
               else {"columns": row_cols})
        if row_attrs:
            out["rowAttrs"] = row_attrs
        if col_attrs:
            out["attrs"] = col_attrs
        return out
    if typ == T_PAIRS:
        return pairs
    if typ == T_VALCOUNT:
        return valcount or {"value": 0, "count": 0}
    if typ == T_ROWIDS:
        return {"rows": row_ids}
    if typ == T_GROUPS:
        return groups
    if typ == T_DISTINCT:
        return {"values": values}
    raise ValueError(f"proto: unknown result type {typ}")


@_malformed_as_value_error
def decode_query_response(buf: bytes) -> dict:
    err = ""
    results = []
    for field, wire, val in _Reader(buf).fields():
        if field == 1:
            err = val.decode()
        elif field == 2:
            results.append(_dec_result(val))
    out = {"results": results}
    if err:
        out["error"] = err
    return out
