#!/usr/bin/env python
"""Assemble crop-window EXR renders into one image.

Replacement for /root/reference/tools/exrassemble.cpp: each input's data
window places it in the output's display window.
"""
import struct
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np


def _data_window(path):
    from prt.io.exr import _read_attrs, _MAGIC
    with open(path, "rb") as f:
        magic, _ = struct.unpack("<ii", f.read(8))
        assert magic == _MAGIC
        attrs = _read_attrs(f)
    dw = struct.unpack("<4i", attrs["dataWindow"][1])
    disp = struct.unpack("<4i", attrs["displayWindow"][1])
    return dw, disp


def main():
    if len(sys.argv) < 3:
        print("usage: exrassemble.py out.exr in1.exr in2.exr ...")
        sys.exit(1)
    from prt.io.exr import read_exr, write_exr
    out_path = sys.argv[1]
    tiles = sys.argv[2:]
    _, disp = _data_window(tiles[0])
    W = disp[2] - disp[0] + 1
    H = disp[3] - disp[1] + 1
    acc = np.zeros((H, W, 3), np.float32)
    alpha = np.zeros((H, W), np.float32)
    for t in tiles:
        rgb, a = read_exr(t)
        (x0, y0, x1, y1), _ = _data_window(t)
        acc[y0:y1 + 1, x0:x1 + 1] = rgb
        if a is not None:
            alpha[y0:y1 + 1, x0:x1 + 1] = a
    write_exr(out_path, acc, alpha)
    print(f"wrote {out_path} ({W}x{H} from {len(tiles)} tiles)")


if __name__ == "__main__":
    main()
