#!/usr/bin/env python3
"""Summarize a jax.profiler xplane trace: per-op device time table.

A dependency-free protobuf wire-format walker for the XSpace container
(tensorflow/core/profiler/protobuf/xplane.proto). It extracts every GPU
device plane's (line, event name, total duration, occurrences) and prints
ops sorted by total time. A GPU plane has several lines over the same
interval (XLA modules, XLA ops, streams), so rows are keyed by line name
and a line's rows are never summed with another's.

Usage: python tools/xplane_summary.py TRACEDIR [--top 30] [--csv]
"""
import glob
import json
import struct
import sys


def _varint(buf, i):
    v = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, i
        shift += 7


def _fields(buf):
    """Yield (field_number, wire_type, value) over one message."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _varint(buf, i)
        fn, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _varint(buf, i)
        elif wt == 1:
            v = struct.unpack_from("<q", buf, i)[0]
            i += 8
        elif wt == 2:
            ln, i = _varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == 5:
            v = struct.unpack_from("<i", buf, i)[0]
            i += 4
        else:
            raise ValueError(f"wire type {wt}")
        yield fn, wt, v


def parse_xspace(path):
    """-> list of planes: dict(name, lines=[...], event_names={id: name})."""
    buf = open(path, "rb").read()
    planes = []
    for fn, wt, v in _fields(buf):
        if fn == 1 and wt == 2:                      # XPlane
            plane = {"name": "", "lines": [], "event_names": {}}
            for pf, pw, pv in _fields(v):
                if pf == 2 and pw == 2:
                    plane["name"] = pv.decode("utf-8", "replace")
                elif pf == 3 and pw == 2:            # XLine
                    line = {"name": "", "events": []}
                    for lf, lw, lv in _fields(pv):
                        if lf == 2 and lw == 2:
                            line["name"] = lv.decode("utf-8", "replace")
                        elif lf == 4 and lw == 2:    # XEvent
                            mid = dur = occ = 0
                            for ef, ew, ev in _fields(lv):
                                if ef == 1:
                                    mid = ev
                                elif ef == 3:
                                    dur = ev
                                elif ef == 5:
                                    occ = ev
                            line["events"].append((mid, dur, occ))
                    plane["lines"].append(line)
                elif pf == 4 and pw == 2:            # event_metadata map
                    k = None
                    name = None
                    for mf, mw, mv in _fields(pv):
                        if mf == 1 and mw == 0:
                            k = mv
                        elif mf == 2 and mw == 2:    # XEventMetadata
                            for emf, emw, emv in _fields(mv):
                                if emf == 1 and emw == 0 and k is None:
                                    k = emv
                                elif emf == 2 and emw == 2:
                                    name = emv.decode("utf-8", "replace")
                    if k is not None and name is not None:
                        plane["event_names"][k] = name
            planes.append(plane)
    return planes


def op_table(tracedir, device_only=True):
    """-> {op name: [total_s, count]} aggregated over device planes."""
    out = {}
    for path in glob.glob(tracedir + "/**/*.xplane.pb", recursive=True):
        for plane in parse_xspace(path):
            if device_only and not plane["name"].startswith("/device:GPU"):
                continue
            names = plane["event_names"]
            for line in plane["lines"]:
                for mid, dur_ps, _occ in line["events"]:
                    nm = f"[{line['name']}] {names.get(mid, f'#{mid}')}"
                    cur = out.setdefault(nm, [0.0, 0])
                    cur[0] += dur_ps * 1e-12
                    cur[1] += 1
    return out


def main():
    tracedir = sys.argv[1]
    top = 30
    as_csv = "--csv" in sys.argv
    if "--top" in sys.argv:
        top = int(sys.argv[sys.argv.index("--top") + 1])
    table = op_table(tracedir)
    rows = sorted(table.items(), key=lambda kv: -kv[1][0])[:top]
    total = sum(v[0] for v in table.values())
    if as_csv:
        print("op,total_s,count")
        for nm, (s, c) in rows:
            print(f"{json.dumps(nm)},{s:.6f},{c}")
    else:
        print(f"{'total_s':>10} {'count':>7}  [line] op   (all lines "
              f"{total:.4f} s)")
        for nm, (s, c) in rows:
            print(f"{s:10.4f} {c:7d}  {nm[:110]}")


if __name__ == "__main__":
    main()
