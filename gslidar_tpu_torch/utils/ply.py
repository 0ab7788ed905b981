"""Tiny PLY reader/writer (binary little-endian), replacing plyfile (the
port's copy of gslidar_tpu/utils/ply.py).

The points3d.ply layout: x y z nx ny nz red green blue time
(reference: scene/scene_utils.py:59-91).
"""

from __future__ import annotations

import numpy as np

_TYPES = {
    "float": ("f4", 4), "float32": ("f4", 4), "double": ("f8", 8),
    "uchar": ("u1", 1), "uint8": ("u1", 1), "char": ("i1", 1),
    "short": ("i2", 2), "ushort": ("u2", 2),
    "int": ("i4", 4), "int32": ("i4", 4), "uint": ("u4", 4),
}


def read_ply(path: str) -> dict[str, np.ndarray]:
    """Read a PLY 'vertex' element into a dict of 1-D arrays per property."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError("not a PLY file")
        fmt = None
        count = 0
        props: list[tuple[str, str]] = []
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in header")
            tok = line.strip().split()
            if not tok:
                continue
            if tok[0] == b"format":
                fmt = tok[1].decode()
            elif tok[0] == b"element":
                in_vertex = tok[1] == b"vertex"
                if in_vertex:
                    count = int(tok[2])
            elif tok[0] == b"property" and in_vertex:
                props.append((tok[2].decode(), _TYPES[tok[1].decode()][0]))
            elif tok[0] == b"end_header":
                break
        if fmt == "ascii":
            data = np.loadtxt(f, max_rows=count)
            return {name: data[:, i].astype(dt)
                    for i, (name, dt) in enumerate(props)}
        endian = "<" if "little" in fmt else ">"
        dtype = np.dtype([(name, endian + dt) for name, dt in props])
        data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype,
                             count=count)
        return {name: np.ascontiguousarray(data[name]) for name, _ in props}


def write_ply(path: str, columns: dict[str, np.ndarray]) -> None:
    """Write named 1-D columns as a binary PLY vertex element.

    float64 -> float32; integer colour columns stay uint8.
    """
    names = list(columns.keys())
    n = len(columns[names[0]])
    fields = []
    for name in names:
        arr = np.asarray(columns[name])
        if arr.dtype.kind == "f":
            arr = arr.astype("<f4")
            ply_t = "float"
        elif arr.dtype == np.uint8:
            arr = arr.astype("u1")
            ply_t = "uchar"
        else:
            arr = arr.astype("<i4")
            ply_t = "int"
        fields.append((name, arr, ply_t))
    dtype = np.dtype([(name, arr.dtype) for name, arr, _ in fields])
    rec = np.empty(n, dtype=dtype)
    for name, arr, _ in fields:
        rec[name] = arr
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    header += [f"property {t} {name}" for name, _, t in fields]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        f.write(rec.tobytes())


def store_points_ply(path, xyz, rgb=None, timestamp=None) -> None:
    """points3d.ply layout (reference: scene/scene_utils.py:72-91)."""
    xyz = np.asarray(xyz, dtype=np.float32)
    n = xyz.shape[0]
    if rgb is None:
        rgb = np.zeros((n, 3), dtype=np.uint8)
    rgb = np.asarray(rgb).astype(np.uint8)
    if timestamp is None:
        timestamp = np.zeros((n, 1), dtype=np.float32)
    timestamp = np.asarray(timestamp, dtype=np.float32).reshape(n)
    normals = np.zeros_like(xyz)
    write_ply(path, {
        "x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
        "nx": normals[:, 0], "ny": normals[:, 1], "nz": normals[:, 2],
        "red": rgb[:, 0], "green": rgb[:, 1], "blue": rgb[:, 2],
        "time": timestamp,
    })


def fetch_points_ply(path):
    """Read points3d.ply -> (points [N,3], colors [N,3] in [0,1],
    normals [N,3], time [N,1] or None)."""
    cols = read_ply(path)
    pts = np.stack([cols["x"], cols["y"], cols["z"]],
                   axis=1).astype(np.float32)
    colors = np.stack([cols["red"], cols["green"], cols["blue"]],
                      axis=1).astype(np.float32) / 255.0
    normals = np.stack([cols.get("nx", np.zeros(len(pts))),
                        cols.get("ny", np.zeros(len(pts))),
                        cols.get("nz", np.zeros(len(pts)))],
                       axis=1).astype(np.float32)
    time = (cols["time"].reshape(-1, 1).astype(np.float32)
            if "time" in cols else None)
    return pts, colors, normals, time


def save_xyz_ply(points, path) -> None:
    """Plain xyz export (reference: utils/system_utils.py:45-63)."""
    pts = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    write_ply(str(path), {"x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2]})
