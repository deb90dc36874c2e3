"""Point-cloud files and file lists (port of the parts of
point_cloud_donkey_tpu/utils/io.py that serving reads).

  * `.pcd` (DATA ascii, binary and binary_compressed) and `.ply` (ascii and
    binary) files, and `.off` meshes sampled on the fly (utils/mesh.py); serving reads the coordinates and, for CSHOT, the
    colours: :func:`read_cloud` returns a :class:`PointCloud` (xyz [N, 3]
    float32, rgb [N, 3] float32 in [0, 1] or None), :func:`load_cloud` its
    xyz.  Every other field is ignored.  Colours: PCL's packed ``rgb`` /
    ``rgba`` float (0x00RRGGBB in its bits) or ``r``, ``g``, ``b`` fields in
    a PCD, ``red``, ``green``, ``blue`` in a PLY, each divided by 255.
  * file lists with a `# train|test [inst]` header followed by
    `path label [instance]` lines; `#`-prefixed lines are comments
    (reference: eval_tool/eval_helpers.h:100-177).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

_PCD_DTYPES = {
    ("F", 4): "<f4", ("F", 8): "<f8",
    ("I", 1): "<i1", ("I", 2): "<i2", ("I", 4): "<i4",
    ("U", 1): "<u1", ("U", 2): "<u2", ("U", 4): "<u4",
}


def _lzf_decompress(data: bytes, expected_size: int) -> bytes:
    """LZF decompression (the format of PCL's binary_compressed PCDs)."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        ctrl = data[i]
        i += 1
        if ctrl < 32:                      # literal run of ctrl + 1 bytes
            out += data[i:i + ctrl + 1]
            i += ctrl + 1
            continue
        length = ctrl >> 5                 # back reference
        if length == 7:
            length += data[i]
            i += 1
        ref = len(out) - ((ctrl & 0x1F) << 8) - data[i] - 1
        i += 1
        if ref < 0:
            raise ValueError("lzf: back reference before the start")
        for _ in range(length + 2):
            out.append(out[ref])
            ref += 1
    if len(out) != expected_size:
        raise ValueError(f"lzf: expected {expected_size} bytes, got {len(out)}")
    return bytes(out)


@dataclass
class PointCloud:
    """The fields of a cloud file that serving and training read."""
    xyz: np.ndarray                       # [N, 3] float32
    rgb: Optional[np.ndarray] = None      # [N, 3] float32 in [0, 1]
    normals: Optional[np.ndarray] = None  # [N, 3] float32, as stored

    def has_normals(self) -> bool:
        """The reference's test (implicit_shape_model.cpp:374-384): the
        first point's normal is finite and not all zero."""
        if self.normals is None or len(self.normals) == 0:
            return False
        n0 = self.normals[0]
        return bool(np.all(np.isfinite(n0)) and np.any(n0 != 0))

    def remove_nan(self) -> "PointCloud":
        """The points whose coordinates are all finite."""
        keep = np.all(np.isfinite(self.xyz), axis=1)
        return PointCloud(
            xyz=self.xyz[keep],
            rgb=None if self.rgb is None else self.rgb[keep],
            normals=None if self.normals is None else self.normals[keep])


def _unpack_rgb(packed: np.ndarray) -> np.ndarray:
    """PCL packs rgb as a float whose bits hold 0x00RRGGBB (an unsigned
    rgba field holds them as its value).  The JAX reader casts an integer
    field to float before reading the bits, which loses them (ROADMAP C);
    the port reads the bits as stored."""
    packed = np.asarray(packed)
    if packed.dtype.kind in "iu":
        as_int = packed.astype(np.uint32)
    else:
        as_int = packed.astype(np.float32).view(np.uint32)
    rgb8 = np.stack([(as_int >> 16) & 0xFF, (as_int >> 8) & 0xFF,
                     as_int & 0xFF], axis=1)
    return rgb8.astype(np.float32) / 255.0


def _rgb_of(field: Dict[str, np.ndarray]) -> Optional[np.ndarray]:
    """Colours of a PCD's fields (name -> [N] column), or None."""
    for packed in ("rgb", "rgba"):
        if packed in field:
            return _unpack_rgb(field[packed])
    if all(c in field for c in "rgb"):
        return np.stack([field[c] for c in "rgb"],
                        axis=1).astype(np.float32) / 255.0
    return None


_PCD_NORMALS = ("normal_x", "normal_y", "normal_z")
_PLY_NORMALS = ("nx", "ny", "nz")


def _normals_of(field: Dict[str, np.ndarray], names) -> Optional[np.ndarray]:
    if not all(c in field for c in names):
        return None
    return np.stack([field[c] for c in names], axis=1).astype(np.float32)


def load_pcd(path: str) -> PointCloud:
    """xyz (and colours, when the file has them) of a PCD file."""
    with open(path, "rb") as f:
        data = f.read()
    header: Dict[str, List[str]] = {}
    offset = 0
    while "DATA" not in header:
        end = data.index(b"\n", offset)
        parts = data[offset:end].decode("ascii", errors="replace").split()
        offset = end + 1
        if parts and not parts[0].startswith("#"):
            header[parts[0]] = parts[1:]

    fields = header["FIELDS"]
    sizes = [int(s) for s in header["SIZE"]]
    types = header["TYPE"]
    counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
    n = int(header["POINTS"][0])
    mode = header["DATA"][0]
    if not {"x", "y", "z"} <= set(fields):
        raise ValueError(f"{path}: PCD without x, y, z fields")
    wanted = [f for f in fields if f in ("x", "y", "z", "rgb", "rgba", "r",
                                         "g", "b") + _PCD_NORMALS]

    field: Dict[str, np.ndarray] = {}
    if mode == "ascii":
        width = sum(counts)
        raw = np.array(data[offset:].split(), dtype=np.float64)
        raw = raw[:n * width].reshape(n, width)
        col = dict(zip(fields, np.cumsum([0] + counts[:-1])))
        for f in wanted:
            i = fields.index(f)
            # ascii holds each value as text: cast to the field's own type
            # (a packed rgb float then keeps its bits)
            field[f] = raw[:, col[f]].astype(_PCD_DTYPES[(types[i],
                                                          sizes[i])])
    elif mode == "binary":
        dtype = np.dtype([(f, _PCD_DTYPES[(t, s)], (c,))
                          for f, s, t, c in zip(fields, sizes, types, counts)])
        rec = np.frombuffer(data, dtype=dtype, count=n, offset=offset)
        field = {f: rec[f][:, 0] for f in wanted}
    elif mode == "binary_compressed":
        comp_size, raw_size = struct.unpack_from("<II", data, offset)
        body = _lzf_decompress(data[offset + 8:offset + 8 + comp_size],
                               raw_size)
        # fields stored one after another (structure of arrays)
        starts = np.cumsum([0] + [s * c * n for s, c in zip(sizes, counts)])
        for f in wanted:
            i = fields.index(f)
            arr = np.frombuffer(body, dtype=_PCD_DTYPES[(types[i], sizes[i])],
                                count=counts[i] * n, offset=int(starts[i]))
            field[f] = arr.reshape(n, counts[i])[:, 0]
    else:
        raise ValueError(f"{path}: unsupported PCD DATA mode {mode!r}")
    xyz = np.stack([field[a].astype(np.float32) for a in "xyz"], axis=1)
    return PointCloud(xyz=xyz, rgb=_rgb_of(field),
                      normals=_normals_of(field, _PCD_NORMALS))


_PLY_DTYPES = {
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
}


def load_ply(path: str) -> PointCloud:
    """xyz (and colours, when it has them) of the vertex element of a PLY
    file."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    fmt = "ascii"
    elements = []                      # [name, count, [(prop, type)]]
    for line in data[:end].decode("ascii", errors="replace").splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append([parts[1], int(parts[2]), []])
        elif parts[0] == "property" and elements:
            elements[-1][2].append((parts[-1], parts[1]))
    if not elements or elements[0][0] != "vertex":
        raise ValueError(f"{path}: the first PLY element must be vertex")
    _, n, props = elements[0]
    if any(typ == "list" for _, typ in props):
        raise ValueError(f"{path}: list properties in the vertex element")
    names = [name for name, _ in props]
    if fmt == "ascii":
        rows = data[end:].decode("ascii", errors="replace").splitlines()[:n]
        raw = np.array([r.split() for r in rows], dtype=np.float64)
        field = {name: raw[:, i] for i, name in enumerate(names)}
    else:
        order = "<" if "little" in fmt else ">"
        dtype = np.dtype([(name, order + _PLY_DTYPES[typ])
                          for name, typ in props])
        rec = np.frombuffer(data, dtype=dtype, count=n, offset=end)
        field = {name: rec[name] for name in names}
    xyz = np.stack([field[a].astype(np.float32) for a in "xyz"], axis=1)
    rgb = None
    if all(c in field for c in ("red", "green", "blue")):
        rgb = np.stack([field[c] for c in ("red", "green", "blue")],
                       axis=1).astype(np.float32) / 255.0
    return PointCloud(xyz=xyz, rgb=rgb, normals=_normals_of(field,
                                                            _PLY_NORMALS))


def load_cloud(path: str) -> np.ndarray:
    """xyz [N, 3] float32 of a `.pcd` or `.ply` file (rows may be NaN)."""
    return read_cloud(path).xyz


def read_cloud(path: str) -> PointCloud:
    """xyz and, when the file has them, colours and normals of a `.pcd` or
    `.ply` file (rows may be NaN); a `.off` mesh (ModelNet) is sampled on
    the fly to PCD_OFF_POINTS points (default 2048) with the seed
    PCD_OFF_SEED (default 0), centred and scaled to the unit sphere, as the
    JAX package's ``load_cloud`` does (utils/mesh.py)."""
    if path.endswith(".pcd"):
        return load_pcd(path)
    if path.endswith(".ply"):
        return load_ply(path)
    if path.endswith(".off"):
        from .mesh import off_to_cloud
        return off_to_cloud(path,
                            n_points=int(os.environ.get("PCD_OFF_POINTS",
                                                        "2048")),
                            seed=int(os.environ.get("PCD_OFF_SEED", "0")))
    raise ValueError(f"unknown extension for {path}")


def save_pcd(path: str, xyz: np.ndarray, binary: bool = False,
             rgb: Optional[np.ndarray] = None,
             normals: Optional[np.ndarray] = None) -> None:
    """Write xyz [N, 3] (and normals [N, 3] as normal_x/y/z, and rgb [N, 3]
    in [0, 1], packed as PCL's rgb float, each channel truncated to 8 bits
    as the JAX package writes it) as a PCD file (DATA ascii, or binary)."""
    xyz = np.asarray(xyz, dtype=np.float32).reshape(-1, 3)
    n = len(xyz)
    fields, cols = "x y z", [xyz]
    if normals is not None:
        fields += " normal_x normal_y normal_z"
        cols.append(np.asarray(normals, np.float32).reshape(n, 3))
    if rgb is not None:
        rgb8 = (np.clip(np.asarray(rgb, np.float32).reshape(n, 3), 0, 1)
                * 255).astype(np.uint32)
        packed = (rgb8[:, 0] << 16) | (rgb8[:, 1] << 8) | rgb8[:, 2]
        fields, cols = fields + " rgb", cols + [packed.view(np.float32)[:, None]]
    mat = np.ascontiguousarray(np.concatenate(cols, axis=1), dtype="<f4")
    k = mat.shape[1]
    header = ("# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
              f"FIELDS {fields}\nSIZE {' '.join(['4'] * k)}\n"
              f"TYPE {' '.join(['F'] * k)}\nCOUNT {' '.join(['1'] * k)}\n"
              f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n")
    if binary:
        with open(path, "wb") as f:
            f.write((header + "DATA binary\n").encode("ascii"))
            f.write(mat.tobytes())
        return
    with open(path, "w") as f:
        f.write(header + "DATA ascii\n")
        for row in mat:
            f.write(" ".join(repr(float(v)) for v in row) + "\n")


@dataclass
class FileList:
    mode: str  # "train" or "test"
    filenames: List[str] = field(default_factory=list)
    class_labels: List[int] = field(default_factory=list)
    instance_labels: List[int] = field(default_factory=list)
    using_instances: bool = False
    # label string -> id, in first-seen order
    class_map: Dict[str, int] = field(default_factory=dict)
    instance_map: Dict[str, int] = field(default_factory=dict)
    # instance id -> the class id of its first line (class id -> itself
    # without instances)
    instance_to_class: Dict[int, int] = field(default_factory=dict)


def parse_file_list(path: str, class_map: Optional[Dict[str, int]] = None,
                    instance_map: Optional[Dict[str, int]] = None
                    ) -> FileList:
    """Parse a `# train|test [inst]` file list.  Label strings become ids
    in first-seen order; pass the training maps to keep the ids of a test
    list consistent with them."""
    with open(path) as f:
        lines = [ln.split() for ln in f.read().splitlines() if ln.split()]
    if not lines or lines[0][0] != "#" or len(lines[0]) < 2:
        raise ValueError(f"{path}: missing '# train|test [inst]' header")
    header = lines[0]
    if header[1] not in ("train", "test"):
        raise ValueError(f"{path}: mode must be train or test, "
                         f"got {header[1]}")
    if len(header) > 2 and header[2] == "detection":
        raise ValueError("detection file list passed to classification parser")
    fl = FileList(mode=header[1],
                  using_instances=len(header) > 2 and header[2] == "inst",
                  class_map=dict(class_map or {}),
                  instance_map=dict(instance_map or {}))

    def convert(label: str, mapping: Dict[str, int]) -> int:
        return mapping.setdefault(label, len(mapping))

    for tok in lines[1:]:
        if tok[0].startswith("#"):
            continue
        fl.filenames.append(tok[0])
        cid = convert(tok[1], fl.class_map)
        fl.class_labels.append(cid)
        iid = convert(tok[2], fl.instance_map) if fl.using_instances else cid
        fl.instance_labels.append(iid)
        fl.instance_to_class.setdefault(iid, cid)
    return fl
