#!/usr/bin/env python
"""EXR -> PNG with the imaging pipeline (tonemap/bloom/gamma/dither).

Replacement for /root/reference/tools/exrtotiff.cpp (TIFF swapped for PNG —
same role: a display-ready 8-bit image). Pure-python PNG writer (zlib).
"""
import argparse
import struct
import sys
import zlib

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np


def write_png(path, rgb8):
    h, w = rgb8.shape[:2]
    raw = b"".join(b"\0" + rgb8[y].tobytes() for y in range(h))

    def chunk(tag, data):
        c = tag + data
        return struct.pack(">I", len(data)) + c + \
            struct.pack(">I", zlib.crc32(c) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 9)))
        f.write(chunk(b"IEND", b""))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--tonemap", choices=["contrast", "maxwhite", "nonlinear",
                                          "highcontrast"], default=None)
    ap.add_argument("--gamma", type=float, default=2.2)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--bloomradius", type=float, default=0.0)
    ap.add_argument("--bloomweight", type=float, default=0.2)
    args = ap.parse_args()

    from prt.io.exr import read_exr
    from prt.tonemaps.tonemaps import apply_imaging_pipeline
    rgb, _ = read_exr(args.input)
    out = apply_imaging_pipeline(
        rgb * args.scale, tonemap=args.tonemap, gamma=args.gamma,
        bloom_radius=args.bloomradius, bloom_weight=args.bloomweight)
    write_png(args.output, np.asarray(out).astype(np.uint8))
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
