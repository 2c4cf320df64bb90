"""Minimal OpenEXR scanline I/O in pure Python (numpy + zlib).

Replacement for /root/reference/core/exrio.cpp (ReadImage /
WriteRGBAImage), without the OpenEXR library dependency: implements the EXR
2.0 scanline format directly — HALF/FLOAT channels, NONE/ZIPS/ZIP
compression (including the byte-reorder + delta predictor the ZIP codecs
use), data/display windows for crop-aware output (film/image.cpp:157-212
passes crop offsets through to the EXR data window).
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

_MAGIC = 20000630
_HALF, _FLOAT, _UINT = 1, 2, 0
_COMP_NONE, _COMP_ZIPS, _COMP_ZIP = 0, 2, 3


def _predictor_encode(buf: np.ndarray) -> bytes:
    """EXR zip pre-filter: alternate-byte split then delta (ImfZip spec)."""
    n = buf.size
    half = (n + 1) // 2
    tmp = np.empty(n, np.uint8)
    tmp[:half] = buf[0::2]
    tmp[half:] = buf[1::2]
    t = tmp.astype(np.int16)
    d = np.empty(n, np.int16)
    d[0] = t[0]
    d[1:] = t[1:] - t[:-1] + (128 + 256)
    return d.astype(np.uint8).tobytes()


def _predictor_decode(data: bytes) -> np.ndarray:
    t = np.frombuffer(data, np.uint8).astype(np.uint8).copy()
    # Undo delta: running sum with +(-384) offsets, mod 256.
    d = t.astype(np.int64)
    d[1:] -= (128 + 256)
    out = np.cumsum(d) % 256
    tmp = out.astype(np.uint8)
    n = tmp.size
    half = (n + 1) // 2
    res = np.empty(n, np.uint8)
    res[0::2] = tmp[:half]
    res[1::2] = tmp[half:]
    return res


def write_exr(path: str, rgb: np.ndarray, alpha: Optional[np.ndarray] = None,
              display_window: Optional[Tuple[int, int, int, int]] = None,
              data_offset: Tuple[int, int] = (0, 0),
              compression: int = _COMP_ZIPS, half: bool = True):
    """Write RGB(A) image. rgb: f32[h,w,3]; alpha optional f32[h,w]."""
    rgb = np.asarray(rgb, np.float32)
    if half:
        # Values beyond half range would overflow the cast to f16; clamp
        # like Imath half's saturating conversion.
        rgb = np.clip(rgb, -65504.0, 65504.0)
    h, w = rgb.shape[:2]
    x0, y0 = data_offset
    if display_window is None:
        display_window = (0, 0, x0 + w - 1, y0 + h - 1)
    dw = (x0, y0, x0 + w - 1, y0 + h - 1)

    chans = [("B", rgb[..., 2]), ("G", rgb[..., 1]), ("R", rgb[..., 0])]
    if alpha is not None:
        chans.insert(0, ("A", np.asarray(alpha, np.float32)))
    pix_t = _HALF if half else _FLOAT
    np_t = np.float16 if half else np.float32

    def attr(name, typ, data):
        return (name.encode() + b"\0" + typ.encode() + b"\0" +
                struct.pack("<i", len(data)) + data)

    chlist = b""
    for name, _ in chans:
        chlist += (name.encode() + b"\0" + struct.pack("<i", pix_t) +
                   b"\0\0\0\0" + struct.pack("<ii", 1, 1))
    chlist += b"\0"

    header = b""
    header += attr("channels", "chlist", chlist)
    header += attr("compression", "compression", bytes([compression]))
    header += attr("dataWindow", "box2i", struct.pack("<4i", *dw))
    header += attr("displayWindow", "box2i", struct.pack("<4i", *display_window))
    header += attr("lineOrder", "lineOrder", b"\0")
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<2f", 0.0, 0.0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\0"

    lines_per_block = 16 if compression == _COMP_ZIP else 1
    nblocks = (h + lines_per_block - 1) // lines_per_block

    blocks = []
    for b in range(nblocks):
        ys = b * lines_per_block
        ye = min(ys + lines_per_block, h)
        raw = b""
        for y in range(ys, ye):
            for _, cdata in chans:
                raw += cdata[y].astype(np_t).tobytes()
        raw_np = np.frombuffer(raw, np.uint8)
        if compression in (_COMP_ZIPS, _COMP_ZIP):
            comp = zlib.compress(_predictor_encode(raw_np))
            if len(comp) >= len(raw):
                comp = raw
        else:
            comp = raw
        blocks.append((ys + y0, comp))

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _MAGIC, 2))
        f.write(header)
        offset_pos = f.tell()
        f.write(b"\0" * (8 * nblocks))
        offsets = []
        for y, comp in blocks:
            offsets.append(f.tell())
            f.write(struct.pack("<ii", y, len(comp)))
            f.write(comp)
        f.seek(offset_pos)
        for off in offsets:
            f.write(struct.pack("<Q", off))


def _read_attrs(f) -> Dict[str, tuple]:
    attrs = {}
    while True:
        name = b""
        c = f.read(1)
        if c == b"\0":
            break
        while c != b"\0":
            name += c
            c = f.read(1)
        typ = b""
        c = f.read(1)
        while c != b"\0":
            typ += c
            c = f.read(1)
        size = struct.unpack("<i", f.read(4))[0]
        data = f.read(size)
        attrs[name.decode()] = (typ.decode(), data)
    return attrs


def read_exr(path: str):
    """Read a scanline EXR. Returns (rgb f32[h,w,3], alpha or None)."""
    with open(path, "rb") as f:
        magic, version = struct.unpack("<ii", f.read(8))
        if magic != _MAGIC:
            raise ValueError(f"{path}: not an EXR file")
        if version & 0x200:
            raise ValueError("tiled EXR not supported")
        attrs = _read_attrs(f)

        # Channels.
        chdata = attrs["channels"][1]
        chans = []
        pos = 0
        while chdata[pos] != 0:
            e = chdata.index(b"\0", pos)
            nm = chdata[pos:e].decode()
            pt = struct.unpack("<i", chdata[e + 1:e + 5])[0]
            chans.append((nm, pt))
            pos = e + 1 + 4 + 4 + 8
        comp = attrs["compression"][1][0]
        dwx0, dwy0, dwx1, dwy1 = struct.unpack("<4i", attrs["dataWindow"][1])
        w = dwx1 - dwx0 + 1
        h = dwy1 - dwy0 + 1

        if comp == _COMP_NONE:
            lines_per_block = 1
        elif comp == _COMP_ZIPS:
            lines_per_block = 1
        elif comp == _COMP_ZIP:
            lines_per_block = 16
        else:
            raise ValueError(f"unsupported compression {comp}")
        nblocks = (h + lines_per_block - 1) // lines_per_block
        offsets = struct.unpack(f"<{nblocks}Q", f.read(8 * nblocks))

        out = {nm: np.zeros((h, w), np.float32) for nm, _ in chans}
        bytes_per_px = {nm: (2 if pt == _HALF else 4) for nm, pt in chans}
        line_bytes = sum(bytes_per_px[nm] for nm, _ in chans) * w

        for off in offsets:
            f.seek(off)
            y, size = struct.unpack("<ii", f.read(8))
            data = f.read(size)
            ys = y - dwy0
            ye = min(ys + lines_per_block, h)
            exp = line_bytes * (ye - ys)
            if comp in (_COMP_ZIPS, _COMP_ZIP) and size != exp:
                data = _predictor_decode(zlib.decompress(data)).tobytes()
            for yy in range(ys, ye):
                pos = (yy - ys) * line_bytes
                for nm, pt in chans:
                    n = w * bytes_per_px[nm]
                    seg = data[pos:pos + n]
                    if pt == _HALF:
                        out[nm][yy] = np.frombuffer(seg, np.float16).astype(np.float32)
                    else:
                        out[nm][yy] = np.frombuffer(seg, np.float32)
                    pos += n

    if "R" in out and "G" in out and "B" in out:
        rgb = np.stack([out["R"], out["G"], out["B"]], -1)
    elif "Y" in out:
        rgb = np.repeat(out["Y"][..., None], 3, -1)
    else:
        first = next(iter(out))
        rgb = np.repeat(out[first][..., None], 3, -1)
    return rgb, out.get("A")
