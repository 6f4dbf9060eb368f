"""Pure-python Parquet I/O (no pyarrow).

The port's own copy of cosyvoice_tpu/data/parquet_io.py (pure Python, so
the two read and write the same bytes; the port imports nothing of the JAX
package).

The reference's v1 corpora are parquet shards read by
`cosyvoice/dataset/processor.py:29-57` (`pq.ParquetFile(url).iter_batches`)
with flat columns (utt/spk/text strings, audio_data bytes, speech_token /
*_embedding lists).  This module implements the subset of the format those
files use, from the spec (github.com/apache/parquet-format):

  * footer FileMetaData via the Thrift *compact* protocol (read + write)
  * data page v1 + v2, dictionary pages
  * encodings: PLAIN, PLAIN_DICTIONARY / RLE_DICTIONARY,
    RLE/bit-packed hybrid definition + repetition levels
  * physical types: BOOLEAN, INT32, INT64, FLOAT, DOUBLE, BYTE_ARRAY
  * logical: UTF8 strings, one-level LIST columns
  * compression: UNCOMPRESSED and SNAPPY (full decoder; the encoder emits
    spec-valid all-literal snappy)

Reader: `read_parquet(path) -> list[dict]` row dicts.
Writer: `write_parquet(path, rows)` — single row group, optional fields,
PLAIN, uncompressed; schema inferred (str/bytes/int/float/list thereof).
"""
from __future__ import annotations

import struct
from typing import Any, Iterator, Optional

import numpy as np

MAGIC = b"PAR1"

# parquet physical types
BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY, FIXED_LEN = range(8)
# ConvertedType
UTF8 = 0
CT_LIST = 3
# repetition
REQUIRED, OPTIONAL, REPEATED = 0, 1, 2
# encodings
ENC_PLAIN, ENC_PLAIN_DICT, ENC_RLE = 0, 2, 3
ENC_BIT_PACKED, ENC_RLE_DICT = 4, 8
# codecs
CODEC_UNCOMPRESSED, CODEC_SNAPPY = 0, 1
# page types
PAGE_DATA, PAGE_INDEX, PAGE_DICT, PAGE_DATA_V2 = 0, 1, 2, 3


# ===================================================================== snappy

def snappy_decompress(buf: bytes) -> bytes:
    """Full snappy raw-format decoder (literals + all three copy tags)."""
    n = 0
    shift = 0
    pos = 0
    while True:
        b = buf[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    out = bytearray()
    L = len(buf)
    while pos < L:
        tag = buf[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:                      # literal
            ln = tag >> 2
            if ln >= 60:
                nbytes = ln - 59
                ln = int.from_bytes(buf[pos:pos + nbytes], "little")
                pos += nbytes
            ln += 1
            out += buf[pos:pos + ln]
            pos += ln
            continue
        if kind == 1:                      # copy, 1-byte offset
            ln = ((tag >> 2) & 7) + 4
            off = ((tag >> 5) << 8) | buf[pos]
            pos += 1
        elif kind == 2:                    # copy, 2-byte offset
            ln = (tag >> 2) + 1
            off = int.from_bytes(buf[pos:pos + 2], "little")
            pos += 2
        else:                              # copy, 4-byte offset
            ln = (tag >> 2) + 1
            off = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
        if off == 0:
            raise ValueError("snappy: zero copy offset")
        if off > len(out):
            raise ValueError(
                f"snappy: copy offset {off} exceeds {len(out)} decoded bytes")
        start = len(out) - off
        for i in range(ln):               # may self-overlap — byte-by-byte
            out.append(out[start + i])
    if len(out) != n:
        raise ValueError(f"snappy: expected {n} bytes, got {len(out)}")
    return bytes(out)


def snappy_compress(data: bytes) -> bytes:
    """Spec-valid snappy: preamble + all-literal chunks (no matching)."""
    out = bytearray()
    n = len(data)
    while True:                            # uncompressed-length varint
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            break
    pos = 0
    while pos < len(data):
        chunk = data[pos:pos + 65536]
        ln = len(chunk) - 1
        if ln < 60:
            out.append(ln << 2)
        else:                              # tag 61 = two little-endian
            out.append(61 << 2)            # length bytes follow
            out += ln.to_bytes(2, "little")
        out += chunk
        pos += 65536
    return bytes(out)


# ======================================================== thrift compact I/O

T_STOP, T_TRUE, T_FALSE, T_BYTE, T_I16, T_I32, T_I64, T_DOUBLE, T_BINARY, \
    T_LIST, T_SET, T_MAP, T_STRUCT = range(13)


class _TReader:
    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def varint(self) -> int:
        r = s = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            r |= (b & 0x7F) << s
            if not b & 0x80:
                return r
            s += 7

    def zigzag(self) -> int:
        v = self.varint()
        return (v >> 1) ^ -(v & 1)

    def read_struct(self) -> dict:
        """Struct -> {field_id: value}; values decoded by wire type."""
        out: dict[int, Any] = {}
        fid = 0
        while True:
            byte = self.buf[self.pos]
            self.pos += 1
            if byte == T_STOP:
                return out
            delta = byte >> 4
            ttype = byte & 0x0F
            if delta == 0:
                fid = self.zigzag()        # long-form field id
            else:
                fid += delta
            out[fid] = self.read_value(ttype)

    def read_value(self, ttype: int):
        if ttype == T_TRUE:
            return True
        if ttype == T_FALSE:
            return False
        if ttype in (T_BYTE,):
            v = self.buf[self.pos]
            self.pos += 1
            return v - 256 if v > 127 else v
        if ttype in (T_I16, T_I32, T_I64):
            return self.zigzag()
        if ttype == T_DOUBLE:
            v = struct.unpack("<d", self.buf[self.pos:self.pos + 8])[0]
            self.pos += 8
            return v
        if ttype == T_BINARY:
            n = self.varint()
            v = self.buf[self.pos:self.pos + n]
            self.pos += n
            return bytes(v)
        if ttype in (T_LIST, T_SET):
            hdr = self.buf[self.pos]
            self.pos += 1
            size = hdr >> 4
            etype = hdr & 0x0F
            if size == 15:
                size = self.varint()
            return [self.read_value(etype) for _ in range(size)]
        if ttype == T_STRUCT:
            return self.read_struct()
        raise ValueError(f"thrift: unsupported type {ttype}")


class _TWriter:
    def __init__(self):
        self.out = bytearray()

    def varint(self, v: int):
        while True:
            b = v & 0x7F
            v >>= 7
            self.out.append(b | (0x80 if v else 0))
            if not v:
                return

    def zigzag(self, v: int):
        self.varint((v << 1) ^ (v >> 63) if v < 0 else v << 1)

    def field(self, last_fid: int, fid: int, ttype: int) -> int:
        delta = fid - last_fid
        if 0 < delta <= 15:
            self.out.append((delta << 4) | ttype)
        else:
            self.out.append(ttype)
            self.zigzag(fid)
        return fid

    def write_struct(self, fields: list[tuple[int, int, Any]]):
        """fields: sorted (field_id, ttype, value)."""
        fid = 0
        for f, t, v in fields:
            if t in (T_TRUE, T_FALSE):
                fid = self.field(fid, f, T_TRUE if v else T_FALSE)
                continue
            fid = self.field(fid, f, t)
            self.write_value(t, v)
        self.out.append(T_STOP)

    def write_value(self, ttype: int, v):
        if ttype in (T_I16, T_I32, T_I64):
            self.zigzag(v)
        elif ttype == T_BINARY:
            data = v.encode() if isinstance(v, str) else v
            self.varint(len(data))
            self.out += data
        elif ttype == T_LIST:
            etype, items = v                    # (elem_ttype, list)
            n = len(items)
            if n < 15:
                self.out.append((n << 4) | etype)
            else:
                self.out.append(0xF0 | etype)
                self.varint(n)
            for it in items:
                self.write_value(etype, it)
        elif ttype == T_STRUCT:
            self.write_struct(v)
        elif ttype == T_DOUBLE:
            self.out += struct.pack("<d", v)
        else:
            raise ValueError(f"thrift write: type {ttype}")


# ================================================================ RLE hybrid

def read_rle_bitpacked(buf: bytes, bit_width: int, count: int,
                       pos: int = 0) -> tuple[np.ndarray, int]:
    """RLE/bit-packed hybrid run decoder -> `count` values."""
    out = np.empty(count, np.int64)
    filled = 0
    r = _TReader(buf, pos)
    byte_width = (bit_width + 7) // 8
    while filled < count:
        header = r.varint()
        if header & 1:                       # bit-packed: header>>1 groups of 8
            n = (header >> 1) * 8
            nbytes = (n * bit_width + 7) // 8
            bits = np.unpackbits(
                np.frombuffer(r.buf, np.uint8, nbytes, r.pos),
                bitorder="little")
            r.pos += nbytes
            vals = bits[: n * bit_width].reshape(n, bit_width)
            vals = (vals.astype(np.int64)
                    << np.arange(bit_width, dtype=np.int64)).sum(1)
            take = min(n, count - filled)
            out[filled: filled + take] = vals[:take]
            filled += take
        else:                                # RLE run
            n = header >> 1
            v = int.from_bytes(r.buf[r.pos: r.pos + byte_width], "little") \
                if byte_width else 0
            r.pos += byte_width
            take = min(n, count - filled)
            out[filled: filled + take] = v
            filled += take
    return out, r.pos


def write_rle(values: np.ndarray, bit_width: int) -> bytes:
    """Encode as RLE runs (fine for levels/dict indices)."""
    out = bytearray()
    byte_width = (bit_width + 7) // 8
    i = 0
    values = np.asarray(values, np.int64)
    n = len(values)
    while i < n:
        j = i
        while j < n and values[j] == values[i]:
            j += 1
        run = j - i
        w = _TWriter()
        w.varint(run << 1)
        out += w.out
        out += int(values[i]).to_bytes(byte_width, "little")
        i = j
    return bytes(out)


# ================================================================== schema

class _Column:
    """Flattened leaf column with its level structure."""

    def __init__(self, name: str, path: list[str], ptype: int,
                 converted: Optional[int], max_def: int, max_rep: int,
                 elem_converted: Optional[int] = None):
        self.name = name                  # top-level field name
        self.path = path                  # path_in_schema
        self.ptype = ptype
        self.converted = converted        # on the leaf element
        self.max_def = max_def
        self.max_rep = max_rep
        self.is_list = max_rep > 0
        self.elem_converted = elem_converted


def _walk_schema(schema: list[dict]) -> list[_Column]:
    """FileMetaData.schema (flat pre-order list of SchemaElement dicts,
    field ids per spec: 1 type, 3 repetition, 4 name, 5 num_children,
    6 converted_type) -> leaf columns."""
    cols: list[_Column] = []
    idx = [1]  # skip root

    def walk(path, max_def, max_rep, top):
        el = schema[idx[0]]
        idx[0] += 1
        name = el[4].decode() if isinstance(el.get(4), bytes) else el.get(4)
        rep = el.get(3, REQUIRED)
        if rep == OPTIONAL:
            max_def += 1
        elif rep == REPEATED:
            max_def += 1
            max_rep += 1
        nchild = el.get(5, 0)
        top = top or name
        if nchild:
            for _ in range(nchild):
                walk(path + [name], max_def, max_rep, top)
        else:
            cols.append(_Column(top, path + [name], el.get(1),
                                el.get(6), max_def, max_rep))

    root_children = schema[0].get(5, 0)
    for _ in range(root_children):
        walk([], 0, 0, None)
    return cols


# ================================================================== reading

def _decode_plain(ptype: int, buf: bytes, n: int) -> list:
    if ptype == BYTE_ARRAY:
        out = []
        pos = 0
        for _ in range(n):
            ln = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
            out.append(bytes(buf[pos:pos + ln]))
            pos += ln
        return out
    if ptype == BOOLEAN:
        bits = np.unpackbits(np.frombuffer(buf, np.uint8), bitorder="little")
        return list(bits[:n].astype(bool))
    fmt = {INT32: np.int32, INT64: np.int64, FLOAT: np.float32,
           DOUBLE: np.float64}[ptype]
    return list(np.frombuffer(buf, fmt, n))


def _read_column_chunk(data: bytes, col_meta: dict, col: _Column) -> list:
    """One column chunk -> per-ROW python values (None / scalar / list)."""
    codec = col_meta.get(4, 0)
    num_values = col_meta[5]
    start = min(x for x in (col_meta.get(9), col_meta.get(11))
                if x is not None)
    pos = start
    dictionary: Optional[list] = None
    defs = np.empty(num_values, np.int64)
    reps = np.empty(num_values, np.int64)
    values: list = []
    got = 0

    def decompress(raw, usize):
        if codec == CODEC_UNCOMPRESSED:
            return raw
        if codec == CODEC_SNAPPY:
            return snappy_decompress(raw)
        raise NotImplementedError(f"parquet codec {codec}")

    while got < num_values:
        r = _TReader(data, pos)
        header = r.read_struct()
        page_type = header[1]
        usize, csize = header[2], header[3]
        body = data[r.pos: r.pos + csize]
        pos = r.pos + csize
        if page_type == PAGE_DICT:
            ph = header[7]
            dictionary = _decode_plain(col.ptype, decompress(body, usize),
                                       ph[1])
            continue
        if page_type == PAGE_DATA:
            ph = header[5]
            n = ph[1]
            enc = ph[2]
            page = decompress(body, usize)
            p = 0
            if col.max_rep > 0:
                ln = int.from_bytes(page[p:p + 4], "little")
                rl, _ = read_rle_bitpacked(page[p + 4: p + 4 + ln],
                                           max(col.max_rep.bit_length(), 1), n)
                p += 4 + ln
            else:
                rl = np.zeros(n, np.int64)
            if col.max_def > 0:
                ln = int.from_bytes(page[p:p + 4], "little")
                dl, _ = read_rle_bitpacked(page[p + 4: p + 4 + ln],
                                           max(col.max_def.bit_length(), 1), n)
                p += 4 + ln
            else:
                dl = np.full(n, col.max_def, np.int64)
            payload = page[p:]
        elif page_type == PAGE_DATA_V2:
            ph = header[8]
            n = ph[1]
            enc = ph[4]
            dlen, rlen = ph.get(5, 0), ph.get(6, 0)
            raw = body
            if col.max_rep > 0 and rlen:
                rl, _ = read_rle_bitpacked(raw[:rlen],
                                           max(col.max_rep.bit_length(), 1), n)
            else:
                rl = np.zeros(n, np.int64)
            if col.max_def > 0 and dlen:
                dl, _ = read_rle_bitpacked(raw[rlen:rlen + dlen],
                                           max(col.max_def.bit_length(), 1), n)
            else:
                dl = np.full(n, col.max_def, np.int64)
            payload = raw[rlen + dlen:]
            if ph.get(7, True) and codec != CODEC_UNCOMPRESSED:
                payload = decompress(payload, usize - rlen - dlen)
        else:
            continue
        n_present = int(np.sum(dl == col.max_def))
        if enc in (ENC_PLAIN_DICT, ENC_RLE_DICT):
            assert dictionary is not None, "dict-encoded page before dict"
            bw = payload[0]
            idxs, _ = read_rle_bitpacked(payload[1:], bw, n_present)
            vals = [dictionary[i] for i in idxs]
        elif enc == ENC_PLAIN:
            vals = _decode_plain(col.ptype, payload, n_present)
        else:
            raise NotImplementedError(f"parquet encoding {enc}")
        defs[got:got + n] = dl
        reps[got:got + n] = rl
        # scatter present values into level order
        vi = iter(vals)
        values.extend(next(vi) if d == col.max_def else None for d in dl)
        got += n

    # assemble rows from levels
    if isinstance(values[0] if values else None, bytes) or col.ptype == BYTE_ARRAY:
        if col.converted == UTF8:
            values = [v.decode("utf-8") if v is not None else None
                      for v in values]
    if col.max_rep == 0:
        return values
    rows: list = []
    cur: Optional[list] = None
    for v, d, rp in zip(values, defs, reps):
        if rp == 0:                         # new row boundary
            if cur is not None:
                rows.append(cur)
                cur = None
            if d == 0:                      # null list
                rows.append(None)
                continue
            if d < col.max_def - 1:         # empty list (group set, no elems)
                rows.append([])
                continue
            cur = []
        if v is not None:
            cur.append(v)
        elif col.max_def >= 3 and d == col.max_def - 1:
            cur.append(None)                # null element inside the list
    if cur is not None:
        rows.append(cur)
    return rows


def read_parquet(path: str) -> list[dict]:
    """Parquet file -> list of row dicts (strings decoded, lists as lists)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != MAGIC or data[-4:] != MAGIC:
        raise ValueError(f"{path}: not a parquet file")
    meta_len = int.from_bytes(data[-8:-4], "little")
    meta = _TReader(data[len(data) - 8 - meta_len: len(data) - 8]).read_struct()
    schema = meta[2]
    cols = _walk_schema(schema)
    columns: dict[str, list] = {c.name: [] for c in cols}
    for rg in meta[4]:
        for chunk, col in zip(rg[1], cols):
            col_meta = chunk[3]
            columns[col.name].extend(_read_column_chunk(data, col_meta, col))
    names = [c.name for c in cols]
    n_rows = len(columns[names[0]]) if names else 0
    return [{name: columns[name][i] for name in names}
            for i in range(n_rows)]


# ================================================================== writing

def _infer(value) -> tuple[int, Optional[int], bool]:
    """-> (physical type, converted type, is_list)"""
    if isinstance(value, str):
        return BYTE_ARRAY, UTF8, False
    if isinstance(value, (bytes, bytearray)):
        return BYTE_ARRAY, None, False
    if isinstance(value, (bool, np.bool_)):
        return BOOLEAN, None, False
    if isinstance(value, (int, np.integer)):
        return INT64, None, False
    if isinstance(value, (float, np.floating)):
        return DOUBLE, None, False
    if isinstance(value, np.ndarray):
        value = value.tolist()
    if isinstance(value, (list, tuple)):
        elem = value[0] if len(value) else 0
        pt, ct, _ = _infer(elem)
        return pt, ct, True
    raise TypeError(f"cannot infer parquet type for {type(value)}")


def _encode_plain(ptype: int, vals: list) -> bytes:
    if ptype == BYTE_ARRAY:
        out = bytearray()
        for v in vals:
            b = v.encode("utf-8") if isinstance(v, str) else bytes(v)
            out += len(b).to_bytes(4, "little") + b
        return bytes(out)
    if ptype == BOOLEAN:
        return np.packbits(np.asarray(vals, bool), bitorder="little").tobytes()
    dt = {INT32: np.int32, INT64: np.int64, FLOAT: np.float32,
          DOUBLE: np.float64}[ptype]
    return np.asarray(vals, dt).tobytes()


def write_parquet(path: str, rows: list[dict], codec: str = "uncompressed") -> None:
    """Single-row-group writer: optional scalars + optional lists, PLAIN,
    uncompressed or snappy — the fixture/corpus-prep counterpart of
    read_parquet."""
    assert rows, "write_parquet: empty rows"
    codec_id = {"uncompressed": CODEC_UNCOMPRESSED,
                "snappy": CODEC_SNAPPY}[codec]
    names = list(rows[0].keys())
    out = bytearray(MAGIC)
    schema: list[tuple] = [(None, None, None)]  # root placeholder
    col_metas = []
    for name in names:
        sample = next(r[name] for r in rows if r[name] is not None)
        ptype, conv, is_list = _infer(sample)
        vals_all: list = []
        defs: list[int] = []
        reps: list[int] = []
        if is_list:
            max_def, max_rep = 3, 1
            for r in rows:
                v = r[name]
                if v is None:
                    defs.append(0)
                    reps.append(0)
                    continue
                v = list(np.asarray(v).tolist()) if not isinstance(v, (list, tuple)) else v
                if not v:
                    defs.append(1)
                    reps.append(0)
                    continue
                for j, e in enumerate(v):
                    defs.append(3)
                    reps.append(0 if j == 0 else 1)
                    vals_all.append(e)
        else:
            max_def, max_rep = 1, 0
            for r in rows:
                v = r[name]
                if v is None:
                    defs.append(0)
                else:
                    defs.append(1)
                    vals_all.append(v)

        payload = bytearray()
        n_values = len(defs)
        if max_rep:
            enc = write_rle(np.asarray(reps), 1)
            payload += len(enc).to_bytes(4, "little") + enc
        enc = write_rle(np.asarray(defs), max(max_def.bit_length(), 1))
        payload += len(enc).to_bytes(4, "little") + enc
        payload += _encode_plain(ptype, vals_all)

        usize = len(payload)
        if codec_id == CODEC_SNAPPY:
            payload = snappy_compress(bytes(payload))
        w = _TWriter()
        w.write_struct([
            (1, T_I32, PAGE_DATA), (2, T_I32, usize),
            (3, T_I32, len(payload)),
            (5, T_STRUCT, [(1, T_I32, n_values), (2, T_I32, ENC_PLAIN),
                           (3, T_I32, ENC_RLE), (4, T_I32, ENC_RLE)]),
        ])
        offset = len(out)
        out += w.out + payload
        total = len(out) - offset
        col_metas.append((name, ptype, conv, is_list, n_values, offset, total))
    data_end = len(out)

    # FileMetaData
    schema_elems = [[(4, T_BINARY, b"schema"), (5, T_I32, len(names))]]
    for name, ptype, conv, is_list, *_ in col_metas:
        if is_list:
            schema_elems.append(
                [(3, T_I32, OPTIONAL), (4, T_BINARY, name.encode()),
                 (5, T_I32, 1), (6, T_I32, CT_LIST)])
            schema_elems.append(
                [(3, T_I32, REPEATED), (4, T_BINARY, b"list"), (5, T_I32, 1)])
            elem = [(1, T_I32, ptype), (3, T_I32, OPTIONAL),
                    (4, T_BINARY, b"element")]
            if conv is not None:
                elem.append((6, T_I32, conv))
            schema_elems.append(elem)
        else:
            el = [(1, T_I32, ptype), (3, T_I32, OPTIONAL),
                  (4, T_BINARY, name.encode())]
            if conv is not None:
                el.append((6, T_I32, conv))
            schema_elems.append(el)

    chunks = []
    for name, ptype, conv, is_list, n_values, offset, total in col_metas:
        pth = [name.encode(), b"list", b"element"] if is_list else [name.encode()]
        cm = [(1, T_I32, ptype), (2, T_LIST, (T_I32, [ENC_PLAIN, ENC_RLE])),
              (3, T_LIST, (T_BINARY, pth)), (4, T_I32, codec_id),
              (5, T_I64, n_values), (6, T_I64, total), (7, T_I64, total),
              (9, T_I64, offset)]
        chunks.append([(2, T_I64, offset), (3, T_STRUCT, cm)])
    row_group = [(1, T_LIST, (T_STRUCT, chunks)),
                 (2, T_I64, data_end - 4), (3, T_I64, len(rows))]
    meta = _TWriter()
    meta.write_struct([
        (1, T_I32, 1),
        (2, T_LIST, (T_STRUCT, schema_elems)),
        (3, T_I64, len(rows)),
        (4, T_LIST, (T_STRUCT, [row_group])),
        (6, T_BINARY, b"cosyvoice_tpu"),
    ])
    out += meta.out
    out += len(meta.out).to_bytes(4, "little")
    out += MAGIC
    with open(path, "wb") as f:
        f.write(out)


def parquet_opener(it: Iterator[str]) -> Iterator[dict]:
    """Pipeline source stage: parquet shard paths -> row-dict samples
    (reference `dataset/processor.py:29-57` parquet_opener)."""
    import logging

    for path in it:
        try:
            rows = read_parquet(path)
        except Exception as ex:  # noqa: BLE001 — mirror the reference's guard
            logging.warning("Failed to open %s, ex info %s", path, ex)
            continue
        yield from rows
