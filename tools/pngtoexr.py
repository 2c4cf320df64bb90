#!/usr/bin/env python
"""PNG -> EXR: inverse of exrtopng, the analogue of the reference's
tifftoexr tool (/root/reference/tools/tifftoexr.cpp:22-85 — 8-bit display
image back to linear float, gamma=2.2 decode). Pure-python PNG reader
(zlib inflate + filter reconstruction; 8-bit RGB/RGBA, non-interlaced)."""
import argparse
import struct
import sys
import zlib

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np


def read_png(path):
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos = 8
    idat = b""
    w = h = bitdepth = colortype = None
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            w, h, bitdepth, colortype, _, _, interlace = \
                struct.unpack(">IIBBBBB", body)
            assert bitdepth == 8, "only 8-bit PNG supported"
            assert colortype in (2, 6), "only RGB/RGBA PNG supported"
            assert interlace == 0, "interlaced PNG unsupported"
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
    ch = 3 if colortype == 2 else 4
    raw = zlib.decompress(idat)
    stride = w * ch
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for y in range(h):
        f = raw[pos]
        row = np.frombuffer(raw[pos + 1:pos + 1 + stride],
                            np.uint8).astype(np.int32)
        pos += 1 + stride
        if f == 0:
            cur = row
        elif f == 2:       # Up
            cur = (row + prev) & 0xFF
        else:              # Sub (1), Average (3), Paeth (4): sequential
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - ch] if x >= ch else 0
                b = prev[x]
                if f == 1:
                    p = a
                elif f == 3:
                    p = (a + b) // 2
                else:
                    c = prev[x - ch] if x >= ch else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    p = a if (pa <= pb and pa <= pc) else \
                        (b if pb <= pc else c)
                cur[x] = (row[x] + p) & 0xFF
        out[y] = cur
        prev = cur
    img = out.reshape(h, w, ch)
    return img[..., :3], (img[..., 3] if ch == 4 else None)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input")
    ap.add_argument("output", nargs="?")
    ap.add_argument("--gamma", type=float, default=2.2,
                    help="display gamma to invert (tifftoexr.cpp:54)")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="linear scale applied after decode")
    args = ap.parse_args()
    out = args.output or (args.input.rsplit(".", 1)[0] + ".exr")

    rgb8, alpha8 = read_png(args.input)
    rgb = (rgb8.astype(np.float32) / 255.0) ** args.gamma * args.scale
    alpha = (alpha8.astype(np.float32) / 255.0
             if alpha8 is not None else np.ones(rgb.shape[:2], np.float32))

    from prt.io.exr import write_exr
    write_exr(out, rgb.astype(np.float32), alpha)
    print(f"{args.input} ({rgb.shape[1]}x{rgb.shape[0]}) -> {out}")


if __name__ == "__main__":
    main()
