"""VTU (VTK XML UnstructuredGrid) export/import, meshio-layout-compatible.

The reference exports eigenfunctions with meshio
(`mesh_helpers.save_eigenfunctions`, src/mesh_helpers.py:44-54) producing
zlib-compressed base64 "binary" VTU files with point_data keys v0..v{k-1}
(golden artifact: outputs/bunny_model.vtu). meshio is not available in
this environment, so this module writes the same on-disk layout from
scratch: VTKFile version 0.1, vtkZLibDataCompressor, block-header encoding
(uint32 [n_blocks, block_size, last_block_size, compressed_sizes...]
base64'd separately from the payload), Float64 points/data, Int64
connectivity/offsets, UInt8 cell types.

A copy of `eigenpinns_tpu/io/vtu.py` (only the header comment names this
package), so that a file written by either package reads back the same
through the other's reader.
"""

from __future__ import annotations

import base64
import xml.etree.ElementTree as ET
import zlib

import numpy as np

_BLOCK_SIZE = 32768  # meshio/VTK default


def _encode_binary(data: np.ndarray) -> str:
    """zlib block compression + base64, meshio-style."""
    raw = data.tobytes()
    n_blocks = max(1, (len(raw) + _BLOCK_SIZE - 1) // _BLOCK_SIZE)
    blocks = [raw[i * _BLOCK_SIZE:(i + 1) * _BLOCK_SIZE]
              for i in range(n_blocks)]
    compressed = [zlib.compress(b) for b in blocks]
    last = len(blocks[-1])
    header = np.array(
        [n_blocks, _BLOCK_SIZE, last] + [len(c) for c in compressed],
        dtype=np.uint32,
    )
    return (base64.b64encode(header.tobytes()).decode()
            + base64.b64encode(b"".join(compressed)).decode())


_VTK_TYPES = {
    np.dtype(np.float64): "Float64",
    np.dtype(np.float32): "Float32",
    np.dtype(np.int64): "Int64",
    np.dtype(np.int32): "Int32",
    np.dtype(np.uint8): "UInt8",
}


def _data_array(name: str, data: np.ndarray, n_components: int | None = None):
    parts = [f'<DataArray type="{_VTK_TYPES[data.dtype]}" Name="{name}"']
    if n_components:
        parts.append(f' NumberOfComponents="{n_components}"')
    parts.append(' format="binary">\n')
    parts.append(_encode_binary(data))
    parts.append("\n</DataArray>\n")
    return "".join(parts)


def write_vtu(path: str, points: np.ndarray, triangles: np.ndarray,
              point_data: dict[str, np.ndarray] | None = None) -> None:
    """Write a triangle mesh + per-point scalar fields as compressed VTU."""
    points = np.ascontiguousarray(points, dtype=np.float64)
    tris = np.ascontiguousarray(triangles, dtype=np.int64)
    n_pts, n_cells = len(points), len(tris)

    out = [
        '<?xml version="1.0"?>\n',
        '<VTKFile type="UnstructuredGrid" version="0.1" '
        'byte_order="LittleEndian" compressor="vtkZLibDataCompressor">\n',
        "<!--This file was created by eigenpinns_torch "
        "(meshio-compatible layout)-->\n",
        "<UnstructuredGrid>\n",
        f'<Piece NumberOfPoints="{n_pts}" NumberOfCells="{n_cells}">\n',
        "<Points>\n",
        _data_array("Points", points, n_components=3),
        "</Points>\n",
        "<Cells>\n",
        _data_array("connectivity", tris.reshape(-1)),
        _data_array("offsets", np.arange(3, 3 * n_cells + 1, 3,
                                         dtype=np.int64)),
        _data_array("types", np.full(n_cells, 5, dtype=np.uint8)),  # triangle
        "</Cells>\n",
    ]
    if point_data:
        out.append("<PointData>\n")
        for name, values in point_data.items():
            out.append(_data_array(
                name, np.ascontiguousarray(values, dtype=np.float64)))
        out.append("</PointData>\n")
    out += ["</Piece>\n", "</UnstructuredGrid>\n", "</VTKFile>\n"]
    import os

    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "w") as fh:
        fh.write("".join(out))


def save_eigenfunctions(path: str, mesh, U: np.ndarray,
                        n_modes: int | None = None) -> None:
    """Reference-parity export (src/mesh_helpers.py:44-54): re-normalize the
    vertices (centroid / max per-axis std — the double normalization noted
    in SURVEY.md section 7) and write point_data keys v0..v{k-1}."""
    n_modes = n_modes if n_modes is not None else U.shape[1]
    verts = mesh.verts
    centroid = verts.mean(axis=0)
    std_max = verts.std(axis=0).max()
    verts = (verts - centroid) / std_max
    point_data = {f"v{i}": np.asarray(U[:, i], dtype=np.float64)
                  for i in range(n_modes)}
    write_vtu(path, verts, mesh.faces, point_data)


def _decode_binary(text: str, dtype) -> np.ndarray:
    blob = base64.b64decode(text.strip())
    # Header: first 12 bytes give n_blocks; full header is 4*(3+n_blocks).
    n_blocks = int(np.frombuffer(blob[:4], dtype=np.uint32)[0])
    header_b64_len = ((4 * (3 + n_blocks) + 2) // 3) * 4
    header = np.frombuffer(
        base64.b64decode(text.strip()[:header_b64_len]), dtype=np.uint32)
    sizes = header[3:3 + n_blocks]
    payload = base64.b64decode(text.strip()[header_b64_len:])
    raw = b""
    off = 0
    for s in sizes:
        raw += zlib.decompress(payload[off:off + s])
        off += int(s)
    return np.frombuffer(raw, dtype=dtype)


_NP_TYPES = {v: k for k, v in _VTK_TYPES.items()}


def read_vtu(path: str):
    """Minimal VTU reader (compressed-binary files written by this module
    or meshio). Returns (points, triangles, point_data)."""
    tree = ET.parse(path)
    root = tree.getroot()
    piece = root.find(".//Piece")
    arrays = {}
    for da in piece.iter("DataArray"):
        dtype = _NP_TYPES[da.attrib["type"]]
        arrays[da.attrib["Name"]] = (_decode_binary(da.text, dtype),
                                     da.attrib)
    pts = arrays["Points"][0].reshape(-1, 3)
    conn = arrays["connectivity"][0].reshape(-1, 3)
    point_data = {
        name: vals for name, (vals, _) in arrays.items()
        if name not in ("Points", "connectivity", "offsets", "types")
    }
    return pts, conn, point_data
