#!/usr/bin/env python
"""Print the average pixel value of EXR file(s).

Replacement for /root/reference/tools/exravg.cpp — the one-number image
checksum used for golden-image regression (SURVEY.md section 4).
"""
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np
from prt.io.exr import read_exr


def main():
    for path in sys.argv[1:]:
        rgb, _ = read_exr(path)
        print(f"{path}: {float(rgb.mean()):.6f} "
              f"(r {rgb[..., 0].mean():.6f} g {rgb[..., 1].mean():.6f} "
              f"b {rgb[..., 2].mean():.6f})")


if __name__ == "__main__":
    main()
