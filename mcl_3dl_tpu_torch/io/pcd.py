"""Minimal PCD (Point Cloud Data) reader/writer, the JAX package's
``io/pcd.py`` restated (numpy only).

Covers what the reference needs from PCL's PCD I/O (``load_pcd`` service
src/mcl_3dl.cpp:1172-1192; shutdown dump :1340-1348): ascii and binary
encodings, xyz + optional intensity/label fields, tolerant field
sniffing like ``mcl_3dl::fromROSMsg`` (point_conversion.h:64-92).
"""

from __future__ import annotations

import numpy as np

_PCD_TO_NP = {
    ("F", 4): "f4", ("F", 8): "f8",
    ("I", 1): "i1", ("I", 2): "i2", ("I", 4): "i4",
    ("U", 1): "u1", ("U", 2): "u2", ("U", 4): "u4",
}


def read_pcd(path):
    """Returns ``(points [N,3] float32, attrs dict of extra columns)``."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            if not line or line.startswith("#"):
                continue
            key, _, val = line.partition(" ")
            header[key.upper()] = val
            if key.upper() == "DATA":
                break
        fields = header["FIELDS"].split()
        sizes = [int(s) for s in header["SIZE"].split()]
        types = header["TYPE"].split()
        counts = [int(c) for c in header.get("COUNT", " ".join(["1"] * len(fields))).split()]
        n = int(header["POINTS"])
        data_mode = header["DATA"].split()[0]

        np_fields = []
        for name, size, typ, cnt in zip(fields, sizes, types, counts):
            base = _PCD_TO_NP[(typ, size)]
            if cnt == 1:
                np_fields.append((name, base))
            else:
                np_fields.append((name, base, (cnt,)))
        dtype = np.dtype(np_fields)

        if data_mode == "ascii":
            raw = np.loadtxt(f, dtype=np.float64, max_rows=n)
            raw = np.atleast_2d(raw)
            rec = np.zeros(n, dtype=dtype)
            col = 0
            for name, size, typ, cnt in zip(fields, sizes, types, counts):
                rec[name] = raw[:, col] if cnt == 1 else raw[:, col:col + cnt]
                col += cnt
        elif data_mode == "binary":
            rec = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype, count=n)
        else:
            raise ValueError(f"unsupported PCD DATA mode: {data_mode}")

    pts = np.stack(
        [rec["x"].astype(np.float32), rec["y"].astype(np.float32),
         rec["z"].astype(np.float32)], axis=1,
    )
    attrs = {
        name: np.asarray(rec[name])
        for name in fields if name not in ("x", "y", "z")
    }
    return pts, attrs


def write_pcd(path, points, attrs=None, binary=True):
    points = np.asarray(points, np.float32).reshape(-1, 3)
    attrs = attrs or {}
    fields = ["x", "y", "z"] + list(attrs.keys())
    cols = [points[:, 0], points[:, 1], points[:, 2]] + [
        np.asarray(v) for v in attrs.values()
    ]
    type_of = {"f4": ("F", 4), "u4": ("U", 4), "i4": ("I", 4)}
    sizes, types = [], []
    np_fields = []
    for name, col in zip(fields, cols):
        key = col.dtype.str[1:]
        t, s = type_of.get(key, ("F", 4))
        sizes.append(str(s))
        types.append(t)
        np_fields.append((name, col.dtype if key in type_of else np.float32))

    n = len(points)
    header = "\n".join([
        "# .PCD v0.7 - Point Cloud Data file format",
        "VERSION 0.7",
        f"FIELDS {' '.join(fields)}",
        f"SIZE {' '.join(sizes)}",
        f"TYPE {' '.join(types)}",
        f"COUNT {' '.join(['1'] * len(fields))}",
        f"WIDTH {n}",
        "HEIGHT 1",
        "VIEWPOINT 0 0 0 1 0 0 0",
        f"POINTS {n}",
        f"DATA {'binary' if binary else 'ascii'}",
        "",
    ])
    rec = np.zeros(n, dtype=np.dtype(np_fields))
    for name, col in zip(fields, cols):
        rec[name] = col
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(rec.tobytes())
        else:
            np.savetxt(f, np.stack([c.astype(np.float64) for c in cols], 1))
