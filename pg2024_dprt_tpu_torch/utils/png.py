"""Minimal PNG writer and reader in numpy and zlib (counterpart of
pg2024_dprt_tpu/utils/png.py, whose bytes the writer reproduces).

`write_png` tone-maps an HDR frame (Reinhard, gamma 2.2) to 8-bit RGB and
writes one IDAT; `read_png` decodes the texture files an OBJ's materials
name to float32 arrays in [0, 1] for scene.textures.build_textures: bit
depths 8 and 16, gray, RGB, palette (with tRNS alpha), gray + alpha and
RGBA, every scanline filter, several IDAT chunks; interlaced files raise.
Host code: no tensor is involved.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def tonemap(img: np.ndarray, exposure: float = 1.0, gamma: float = 2.2) -> np.ndarray:
    """Simple reinhard + gamma -> uint8."""
    x = np.asarray(img, np.float32) * exposure
    x = x / (1.0 + x)
    x = np.clip(x, 0.0, 1.0) ** (1.0 / gamma)
    return (x * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, img: np.ndarray):
    """img: (H, W, 3) uint8 (use tonemap() for HDR input)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = tonemap(img)
    h, w = img.shape[:2]
    if img.ndim == 2:
        img = img[:, :, None].repeat(3, axis=2)

    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))

def _unfilter(data: bytes, h: int, w: int, bpp: int, rowbytes: int) -> np.ndarray:
    """Undo PNG per-scanline filtering -> (h, rowbytes) uint8.

    Filters 0/1/2 (none/sub/up — everything common encoders emit for
    flat-color or photographic rows) are fully vectorized; 3/4
    (average/paeth) take a per-row python loop over pixels."""
    arr = np.frombuffer(data, np.uint8)
    arr = arr[: h * (rowbytes + 1)].reshape(h, rowbytes + 1)
    ftypes = arr[:, 0]
    rows = arr[:, 1:].astype(np.int32)
    out = np.zeros((h, rowbytes), np.uint8)
    prev = np.zeros((rowbytes,), np.int32)
    for y in range(h):
        f = int(ftypes[y])
        raw = rows[y]
        if f == 0:
            rec = raw
        elif f == 1:  # sub: cumsum over pixel groups, mod 256
            g = raw.reshape(-1, bpp) if rowbytes % bpp == 0 else None
            if g is not None:
                rec = (np.cumsum(g, axis=0) & 0xFF).reshape(-1)
            else:  # odd tail (sub-byte depths) — sequential fallback
                rec = raw.copy()
                for x in range(bpp, rowbytes):
                    rec[x] = (rec[x] + rec[x - bpp]) & 0xFF
        elif f == 2:  # up
            rec = (raw + prev) & 0xFF
        elif f == 3:  # average
            rec = raw.copy()
            for x in range(rowbytes):
                a = rec[x - bpp] if x >= bpp else 0
                rec[x] = (rec[x] + ((a + prev[x]) >> 1)) & 0xFF
        elif f == 4:  # paeth
            rec = raw.copy()
            for x in range(rowbytes):
                a = int(rec[x - bpp]) if x >= bpp else 0
                b = int(prev[x])
                c = int(prev[x - bpp]) if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                rec[x] = (rec[x] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {f} on row {y}")
        out[y] = rec.astype(np.uint8)
        prev = rec
    return out


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file -> float32 (H, W, C) in [0, 1].

    Supports bit depths 8/16, color types gray(0)/RGB(2)/palette(3)/
    gray+alpha(4)/RGBA(6), multiple IDATs, tRNS palette alpha.  Interlaced
    (Adam7) files are rejected — re-export without interlacing."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    w = h = depth = ctype = None
    interlace = 0
    idat = []
    plte = None
    trns = None
    while pos + 8 <= len(blob):
        (length,) = struct.unpack(">I", blob[pos : pos + 4])
        tag = blob[pos + 4 : pos + 8]
        data = blob[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, depth, ctype, _comp, _filt, interlace = struct.unpack(">IIBBBBB", data)
        elif tag == b"PLTE":
            plte = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = np.frombuffer(data, np.uint8)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if w is None:
        raise ValueError(f"{path}: missing IHDR")
    if interlace:
        raise ValueError(f"{path}: Adam7 interlacing not supported")
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    if ctype == 3 and depth != 8:
        raise ValueError(f"{path}: palette bit depth {depth} not supported")
    if depth not in (8, 16):
        raise ValueError(f"{path}: bit depth {depth} not supported")
    bpp = max(1, channels * depth // 8)
    rowbytes = (w * channels * depth + 7) // 8
    raw = zlib.decompress(b"".join(idat))
    rec = _unfilter(raw, h, w, bpp, rowbytes)
    if depth == 16:
        img = rec.reshape(h, rowbytes).view(">u2").astype(np.float32) / 65535.0
        img = img.reshape(h, w, channels)
    else:
        img = rec.reshape(h, w, channels).astype(np.float32)
        if ctype == 3:
            pal = (plte.astype(np.float32) / 255.0) if plte is not None else None
            if pal is None:
                raise ValueError(f"{path}: palette image without PLTE")
            idx = img[:, :, 0].astype(np.int32)
            rgb = pal[idx]
            if trns is not None:
                a = np.ones((pal.shape[0],), np.float32)
                a[: trns.shape[0]] = trns.astype(np.float32) / 255.0
                return np.concatenate([rgb, a[idx][:, :, None]], axis=2)
            return rgb
        img = img / 255.0
    return img
