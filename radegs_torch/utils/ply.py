"""Self-contained PLY reader/writer (binary little-endian + ascii).

Replaces the reference's `plyfile` dependency. The vertex layout written by
``save_gaussian_ply`` is byte-compatible with the reference's interchange
format (scene/gaussian_model.py:363-397): x,y,z,nx,ny,nz,f_dc_0..2,
f_rest_0..44,opacity,scale_0..2,rot_0..3,filter_3D — so PLYs round-trip with
the reference tooling and any 3DGS viewer.

The port's own copy of ``radegs_tpu/utils/ply.py`` (the reader and writer
that the Gaussian PLY I/O needs, and the mesh writer / reader of the
extractors), so ``radegs_torch`` imports nothing of the JAX package.
"""

from __future__ import annotations

import io
from typing import Dict, List, Sequence, Tuple

import numpy as np

_DTYPES = {
    "char": "i1",
    "uchar": "u1",
    "short": "i2",
    "ushort": "u2",
    "int": "i4",
    "int32": "i4",
    "uint": "u4",
    "uint32": "u4",
    "float": "f4",
    "float32": "f4",
    "double": "f8",
    "float64": "f8",
}
_INV_DTYPES = {"i1": "char", "u1": "uchar", "i2": "short", "u2": "ushort",
               "i4": "int", "u4": "uint", "f4": "float", "f8": "double"}


def write_ply(path, elements: Dict[str, np.ndarray], comments: Sequence[str] = ()):
    """Write structured arrays as a binary-LE PLY.

    elements: {"vertex": structured array, "face": structured array with a
    'vertex_indices' O-field or (N,3) int array under key 'face_indices'}.
    """
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        for c in comments:
            f.write(f"comment {c}\n".encode())
        bodies = []
        for name, arr in elements.items():
            if name == "face" and arr.dtype.fields is None:
                faces = np.ascontiguousarray(arr, np.int32)
                n, k = faces.shape
                f.write(f"element face {n}\n".encode())
                f.write(b"property list uchar int vertex_indices\n")
                body = np.empty(n, dtype=[("k", "u1"), ("v", "i4", (k,))])
                body["k"] = k
                body["v"] = faces
                bodies.append(body.tobytes())
                continue
            f.write(f"element {name} {len(arr)}\n".encode())
            for field in arr.dtype.names:
                dt = arr.dtype.fields[field][0]
                f.write(f"property {_INV_DTYPES[dt.str[1:]]} {field}\n".encode())
            bodies.append(np.ascontiguousarray(arr).tobytes())
        f.write(b"end_header\n")
        for b in bodies:
            f.write(b)


def read_ply(path) -> Dict[str, np.ndarray]:
    """Read a PLY file. Returns {element_name: structured array}. List
    properties (faces) come back as an (N, K) int array when K is constant."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii", errors="replace").splitlines()
    body = data[header_end:]

    fmt = None
    elements: List[Tuple[str, int, list]] = []
    for line in header:
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append((tok[1], int(tok[2]), []))
        elif tok[0] == "property":
            if tok[1] == "list":
                elements[-1][2].append(("__list__", tok[2], tok[3], tok[4]))
            else:
                elements[-1][2].append((tok[2], tok[1]))

    out: Dict[str, np.ndarray] = {}
    if fmt == "ascii":
        text = body.decode("ascii").split()
        pos = 0
        for name, count, props in elements:
            if props and props[0][0] == "__list__":
                rows = []
                for _ in range(count):
                    k = int(text[pos]); pos += 1
                    rows.append([int(x) for x in text[pos : pos + k]])
                    pos += k
                out[name] = np.asarray(rows)
            else:
                dt = np.dtype([(p[0], _DTYPES[p[1]]) for p in props])
                arr = np.empty(count, dt)
                for i in range(count):
                    for p in props:
                        arr[p[0]][i] = float(text[pos]); pos += 1
                out[name] = arr
        return out

    if fmt not in ("binary_little_endian",):
        raise ValueError(f"unsupported PLY format {fmt}")
    buf = io.BytesIO(body)
    for name, count, props in elements:
        if props and props[0][0] == "__list__":
            _, cnt_t, val_t, _ = props[0]
            cnt_dt = np.dtype("<" + _DTYPES[cnt_t])
            val_dt = np.dtype("<" + _DTYPES[val_t])
            rows = []
            for _ in range(count):
                k = int(np.frombuffer(buf.read(cnt_dt.itemsize), cnt_dt)[0])
                rows.append(np.frombuffer(buf.read(val_dt.itemsize * k), val_dt))
            ks = {len(r) for r in rows}
            out[name] = np.stack(rows) if len(ks) == 1 else np.asarray(rows, object)
        else:
            dt = np.dtype([(p[0], "<" + _DTYPES[p[1]]) for p in props])
            out[name] = np.frombuffer(buf.read(dt.itemsize * count), dt).copy()
    return out


def write_mesh(path, vertices: np.ndarray, faces: np.ndarray,
               vertex_colors: np.ndarray | None = None):
    """A triangle mesh as a binary PLY: float x, y, z per vertex (uchar red,
    green, blue with ``vertex_colors``, floats in [0, 1] scaled by 255) and
    int vertex-index lists."""
    fields = [("x", "f4"), ("y", "f4"), ("z", "f4")]
    if vertex_colors is not None:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    varr = np.empty(len(vertices), dtype=fields)
    varr["x"], varr["y"], varr["z"] = vertices[:, 0], vertices[:, 1], vertices[:, 2]
    if vertex_colors is not None:
        c = np.clip(vertex_colors * 255 if vertex_colors.dtype.kind == "f" else vertex_colors,
                    0, 255).astype(np.uint8)
        varr["red"], varr["green"], varr["blue"] = c[:, 0], c[:, 1], c[:, 2]
    write_ply(path, {"vertex": varr, "face": np.asarray(faces, np.int32)})


def read_mesh(path):
    """(vertices (V, 3) float32, faces (F, 3) int64) of a mesh PLY."""
    d = read_ply(path)
    v = d["vertex"]
    pts = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    return pts, np.asarray(d["face"], np.int64)
