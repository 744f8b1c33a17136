"""Minimal OpenEXR scanline codec (NONE/ZIP/ZIPS compression, half/float32).

A copy of pg2024_dprt_tpu/utils/exr.py. Frames are saved as EXR and the
training datasets are EXRs written by OpenCV, which writes HALF pixels with
ZIP compression by default. This is a small pure-numpy implementation of the
EXR 2.0 scanline format (no OpenEXR binding needed) covering:

- write: compression NONE or ZIP, pixel type float32 or half
- read: compression NONE (0), ZIPS (2, one line/chunk) and ZIP (3, 16
  lines/chunk) with any mix of half/float/uint channels — enough to load
  reference-produced (OpenCV-written) datasets as well as our own frames.

The ZIP codec is zlib plus OpenEXR's byte-delta predictor and two-way
interleave (OpenEXR ImfZip.cpp semantics, reimplemented in numpy).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 20000630
_VERSION = 2

# pixel type enum: 0=uint, 1=half, 2=float
_PT_HALF = 1
_PT_FLOAT = 2

# compression enum
_C_NONE = 0
_C_ZIPS = 2   # 1 scanline / chunk
_C_ZIP = 3    # 16 scanlines / chunk
_LINES_PER_CHUNK = {_C_NONE: 1, _C_ZIPS: 1, _C_ZIP: 16}


def _write_attr(f, name: bytes, type_: bytes, value: bytes):
    f.write(name + b"\x00" + type_ + b"\x00" + struct.pack("<i", len(value)) + value)


def _zip_predict_encode(raw: bytes) -> bytes:
    """OpenEXR ZIP pre-filter (ImfZip.cpp compress): split even/odd bytes
    into two planar halves, then byte-delta + 128."""
    a = np.frombuffer(raw, np.uint8)
    n = a.size
    half = (n + 1) // 2
    split = np.empty(n, np.uint8)
    split[:half] = a[0::2]
    split[half:] = a[1::2]
    d = split.astype(np.int16)
    d[1:] = d[1:] - split[:-1].astype(np.int16) + 128
    return (d & 0xFF).astype(np.uint8).tobytes()


def _zip_predict_decode(raw: bytes) -> bytes:
    """Inverse pre-filter (ImfZip.cpp uncompress): undo the byte delta,
    then re-interleave the two halves."""
    d = np.frombuffer(raw, np.uint8)
    # undo byte delta: rec[i] = rec[i-1] + d[i] - 128 (cumsum mod 256)
    delta = d.astype(np.int64).copy()
    delta[1:] -= 128
    rec = (np.cumsum(delta) & 0xFF).astype(np.uint8)
    n = rec.size
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = rec[:half]
    out[1::2] = rec[half:]
    return out.tobytes()


def write_exr(path: str, image: np.ndarray, channel_names=None,
              compression: str = "none", pixel_type: str = "float"):
    """Write (H, W) or (H, W, C) image as a scanline EXR.

    compression: "none" | "zip" | "zips"; pixel_type: "float" | "half"
    (the reference's OpenCV-written datasets use half+zip)."""
    img = np.asarray(image, np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    if channel_names is None:
        channel_names = {1: ["Y"], 3: ["R", "G", "B"], 4: ["R", "G", "B", "A"]}.get(
            c, [f"channel{i}" for i in range(c)]
        )
    assert len(channel_names) == c
    comp = {"none": _C_NONE, "zip": _C_ZIP, "zips": _C_ZIPS}[compression]
    ptype = {"float": _PT_FLOAT, "half": _PT_HALF}[pixel_type]
    dtype = "<f4" if ptype == _PT_FLOAT else "<f2"
    psize = 4 if ptype == _PT_FLOAT else 2
    lpc = _LINES_PER_CHUNK[comp]
    # EXR stores channels per scanline sorted by name.
    order = sorted(range(c), key=lambda i: channel_names[i])

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _MAGIC, _VERSION))

        chl = b""
        for i in order:
            chl += channel_names[i].encode() + b"\x00"
            chl += struct.pack("<iiii", ptype, 0, 1, 1)  # type, pLinear+resv, xs, ys
        chl += b"\x00"
        _write_attr(f, b"channels", b"chlist", chl)
        _write_attr(f, b"compression", b"compression", bytes([comp]))
        box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
        _write_attr(f, b"dataWindow", b"box2i", box)
        _write_attr(f, b"displayWindow", b"box2i", box)
        _write_attr(f, b"lineOrder", b"lineOrder", b"\x00")  # increasing Y
        _write_attr(f, b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
        _write_attr(f, b"screenWindowCenter", b"v2f", struct.pack("<ff", 0.0, 0.0))
        _write_attr(f, b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
        f.write(b"\x00")  # end of header

        planar = img[:, :, order].astype(dtype)  # (h, w, c) in name order
        nchunks = -(-h // lpc)
        chunks = []
        for ci in range(nchunks):
            y0 = ci * lpc
            lines = planar[y0:y0 + lpc]
            raw = b"".join(
                np.ascontiguousarray(lines[j].T).tobytes()
                for j in range(lines.shape[0]))
            if comp == _C_NONE:
                payload = raw
            else:
                z = zlib.compress(_zip_predict_encode(raw))
                # OpenEXR keeps the raw bytes when compression doesn't help
                payload = z if len(z) < len(raw) else raw
            chunks.append((y0, payload))

        table_pos = f.tell()
        off = table_pos + 8 * nchunks
        for y0, payload in chunks:
            f.write(struct.pack("<Q", off))
            off += 8 + len(payload)
        for y0, payload in chunks:
            f.write(struct.pack("<ii", y0, len(payload)))
            f.write(payload)


def read_exr(path: str):
    """Read a scanline EXR (compression NONE/ZIPS/ZIP; half/float/uint
    channels — covers our own frames and reference OpenCV-written files).

    Returns (image (H, W, C) float32, channel_names list in file order)."""
    with open(path, "rb") as f:
        data = f.read()

    magic, version = struct.unpack_from("<ii", data, 0)
    assert magic == _MAGIC, f"not an EXR file: {path}"
    pos = 8

    def read_cstr(p):
        end = data.index(b"\x00", p)
        return data[p:end].decode(), end + 1

    channels = []
    data_window = None
    compression = None
    while True:
        if data[pos] == 0:
            pos += 1
            break
        name, pos = read_cstr(pos)
        type_, pos = read_cstr(pos)
        (size,) = struct.unpack_from("<i", data, pos)
        pos += 4
        value = data[pos : pos + size]
        pos += size
        if name == "channels":
            q = 0
            while value[q] != 0:
                cname_end = value.index(b"\x00", q)
                cname = value[q:cname_end].decode()
                q = cname_end + 1
                ptype, _resv, _xs, _ys = struct.unpack_from("<iiii", value, q)
                q += 16
                channels.append((cname, ptype))
        elif name == "dataWindow":
            data_window = struct.unpack("<iiii", value)
        elif name == "compression":
            compression = value[0]

    assert compression in _LINES_PER_CHUNK, (
        f"unsupported EXR compression {compression} (NONE/ZIPS/ZIP only)")
    x0, y0, x1, y1 = data_window
    w, h = x1 - x0 + 1, y1 - y0 + 1
    c = len(channels)
    lpc = _LINES_PER_CHUNK[compression]
    nchunks = -(-h // lpc)
    bytes_per_sample = {_PT_FLOAT: 4, _PT_HALF: 2, 0: 4}
    line_bytes = sum(bytes_per_sample[pt] * w for _, pt in channels)

    pos += 8 * nchunks  # skip offset table
    img = np.zeros((h, w, c), np.float32)
    for _ in range(nchunks):
        y, size = struct.unpack_from("<ii", data, pos)
        pos += 8
        nlines = min(lpc, y1 - y + 1)
        raw = data[pos:pos + size]
        pos += size
        if compression != _C_NONE and size < nlines * line_bytes:
            raw = _zip_predict_decode(zlib.decompress(raw))
        q = 0
        for j in range(nlines):
            for ci, (cname, ptype) in enumerate(channels):
                if ptype == _PT_FLOAT:
                    arr = np.frombuffer(raw, "<f4", w, q)
                    q += 4 * w
                elif ptype == _PT_HALF:
                    arr = np.frombuffer(raw, "<f2", w, q).astype(np.float32)
                    q += 2 * w
                else:
                    arr = np.frombuffer(raw, "<u4", w, q).astype(np.float32)
                    q += 4 * w
                img[y - y0 + j, :, ci] = arr

    return img, [c[0] for c in channels]
