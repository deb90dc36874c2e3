"""The port's host utilities against the JAX package's: `.ism` configs,
point-cloud files in every supported encoding, and file lists read alike."""

import json
import os
import struct

import numpy as np
import pytest

from point_cloud_donkey_tpu.utils import config as jconfig
from point_cloud_donkey_tpu.utils import io as jio
from point_cloud_donkey_tpu_torch.utils import config as tconfig
from point_cloud_donkey_tpu_torch.utils import io as tio

CODEBOOK = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "point_cloud_donkey_tpu_torch", "data",
    "bench_codebook.ism")

# (child or "" for the root, parameter, default) as the readers ask for them
_LOOKUPS = [
    ("", "NormalRadius", 0.05), ("", "ConsistentNormalsMethod", 2),
    ("", "DistanceType", "Euclidean"), ("", "UseSvmTraining", False),
    ("Features", "Radius", 0.1), ("Features", "ReferenceFrameRadius", 0.2),
    ("Keypoints", "LeafSize", 0.02), ("Voting", "Bandwidth", 0.1),
    ("Codebook", "UseMatchingWeight", False), ("Codebook", "Missing", 7),
]


def _node(cfg, child):
    return cfg.root if not child else cfg.child(child)


def test_config_reads_the_bench_model_alike():
    j, t = jconfig.IsmConfig.load(CODEBOOK), tconfig.IsmConfig.load(CODEBOOK)
    for child, name, default in _LOOKUPS:
        a, b = _node(j, child).get(name, default), _node(t, child).get(
            name, default)
        assert (a, type(a)) == (b, type(b)), (child, name)
    for child in ("Features", "Keypoints", "Voting", "Codebook"):
        assert j.child(child).type == t.child(child).type
    act = ("ActivationStrategy", "K", 1)
    assert (j.child("Codebook").child(act[0]).get(*act[1:])
            == t.child("Codebook").child(act[0]).get(*act[1:]))


@pytest.mark.parametrize("value,default", [
    (3, 1.0), ("0.5", 0.1), (2.0, 1), (True, False), ("x", "y"), ([1], None),
    (1, True), (True, 1)])
def test_config_coercion_matches(value, default):
    obj = {"ObjectConfig": {"Parameters": {"P": value}}}
    outs = []
    for mod in (jconfig, tconfig):
        try:
            got = mod.IsmConfig.from_json(json.loads(json.dumps(obj))) \
                .root.get("P", default)
            outs.append(("ok", got, type(got)))
        except mod.ConfigError:
            outs.append(("error",))
    assert outs[0] == outs[1]


def _lzf_literals(payload: bytes) -> bytes:
    """LZF stream of literal runs only (a valid, uncompressed encoding)."""
    return b"".join(bytes([len(payload[i:i + 32]) - 1]) + payload[i:i + 32]
                    for i in range(0, len(payload), 32))


def _write_compressed_pcd(path, xyz, extra):
    """binary_compressed PCD with fields x y z intensity (SoA body)."""
    n = len(xyz)
    body = b"".join(np.ascontiguousarray(c, "<f4").tobytes()
                    for c in (xyz[:, 0], xyz[:, 1], xyz[:, 2], extra))
    comp = _lzf_literals(body)
    header = ("VERSION 0.7\nFIELDS x y z intensity\nSIZE 4 4 4 4\n"
              "TYPE F F F F\nCOUNT 1 1 1 1\n"
              f"WIDTH {n}\nHEIGHT 1\nPOINTS {n}\nDATA binary_compressed\n")
    with open(path, "wb") as f:
        f.write(header.encode() + struct.pack("<II", len(comp), len(body))
                + comp)


def _write_ply(path, xyz, fmt):
    n = len(xyz)
    nrm = np.ones_like(xyz)
    header = (f"ply\nformat {fmt} 1.0\nelement vertex {n}\n"
              "property float x\nproperty float y\nproperty float z\n"
              "property float nx\nproperty float ny\nproperty float nz\n"
              "element face 0\nproperty list uchar int vertex_indices\n"
              "end_header\n")
    rows = np.concatenate([xyz, nrm], 1).astype(np.float32)
    with open(path, "wb") as f:
        f.write(header.encode())
        if fmt == "ascii":
            f.write("".join(" ".join(repr(float(v)) for v in r) + "\n"
                            for r in rows).encode())
        else:
            f.write(rows.astype(">f4" if "big" in fmt else "<f4").tobytes())


@pytest.mark.parametrize("kind", ["ascii", "binary", "ascii_rich",
                                  "binary_rich", "binary_compressed",
                                  "ply_ascii", "ply_le", "ply_be"])
def test_point_cloud_files_load_alike(tmp_path, kind):
    """load_cloud returns the JAX loader's xyz bit for bit, whatever other
    fields the file carries."""
    rng = np.random.default_rng(3)
    xyz = rng.normal(size=(257, 3)).astype(np.float32)
    xyz[5] = np.nan
    rich = jio.PointCloud(xyz=xyz, normals=rng.normal(size=(257, 3)).astype(
        np.float32), rgb=rng.random((257, 3)).astype(np.float32))
    path = str(tmp_path / ("c.ply" if kind.startswith("ply") else "c.pcd"))
    if kind in ("ascii", "binary"):
        jio.save_pcd(path, jio.PointCloud(xyz=xyz), binary=kind == "binary")
    elif kind.endswith("_rich"):
        jio.save_pcd(path, rich, binary=kind == "binary_rich")
    elif kind == "binary_compressed":
        _write_compressed_pcd(path, xyz, rng.random(257))
    else:
        _write_ply(path, xyz, {"ply_ascii": "ascii",
                               "ply_le": "binary_little_endian",
                               "ply_be": "binary_big_endian"}[kind])
    got = tio.load_cloud(path)
    assert got.dtype == np.float32 and got.shape == (257, 3)
    np.testing.assert_array_equal(got, jio.load_cloud(path).xyz)
    np.testing.assert_array_equal(got, xyz)


@pytest.mark.parametrize("binary", [False, True])
def test_save_pcd_reads_back_in_the_jax_package(tmp_path, binary):
    xyz = np.random.default_rng(4).normal(size=(100, 3)).astype(np.float32)
    path = str(tmp_path / "c.pcd")
    tio.save_pcd(path, xyz, binary=binary)
    np.testing.assert_array_equal(jio.load_cloud(path).xyz, xyz)


def test_lzf_back_references_decode_alike():
    # literal "abc", then a back reference of length 7 + 2 at distance 3
    comp = bytes([2]) + b"abc" + bytes([(7 - 2) << 5 | 0, 2])
    assert tio._lzf_decompress(comp, 10) == jio._lzf_decompress(comp, 10) \
        == b"abcabcabca"
    with pytest.raises(ValueError):
        tio._lzf_decompress(comp, 11)


@pytest.mark.parametrize("text", [
    "# test\na.pcd car\n# comment\nb.pcd bike\nc.pcd car\n",
    "# train inst\na.pcd car red\nb.pcd car blue\nc.pcd bike red\n",
])
def test_file_lists_parse_alike(tmp_path, text):
    path = tmp_path / "list.txt"
    path.write_text(text)
    j = jio.parse_file_list(str(path), class_map={"bike": 0})
    t = tio.parse_file_list(str(path), class_map={"bike": 0})
    for name in ("mode", "filenames", "class_labels", "instance_labels",
                 "using_instances", "class_map", "instance_map"):
        assert getattr(j, name) == getattr(t, name), name


@pytest.mark.parametrize("text", ["a.pcd 0\n", "# eval\na.pcd 0\n",
                                  "# test detection\na.pcd 0\n"])
def test_bad_file_lists_raise(tmp_path, text):
    path = tmp_path / "list.txt"
    path.write_text(text)
    with pytest.raises(ValueError):
        tio.parse_file_list(str(path))
