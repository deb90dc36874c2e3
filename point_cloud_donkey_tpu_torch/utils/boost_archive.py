"""Reference `.ismd` model exchange: boost binary_archive codec (the port's
copy of point_cloud_donkey_tpu/utils/boost_archive.py; its states are the
port's models/ism.TrainedState and models/codebook.TrainedCodebook).

The reference persists trained models as a JSON `.ism` config plus a boost
binary_oarchive `.ismd` blob (utils/json_object.cpp:41-95).  This module
reads and writes that blob so models trained by either implementation can
be exchanged:

  * archive framing (boost/archive/basic_binary_oarchive.hpp): an 8-byte
    size_t-prefixed signature string "serialization::archive" followed by a
    2-byte library version;
  * primitives are raw native little-endian (int/unsigned 4 bytes, float 4
    bytes); std::string is size_t length + bytes; std::vector of arithmetic
    types is a collection_size_type count (size_t for library version >= 6,
    else u32) + the raw element array (boost's array optimization, no
    per-item metadata);
  * payload layout transcribed from the reference's iSaveData chain:
    ImplicitShapeModel (implicit_shape_model.cpp:1144-1179) -> Codebook
    (codebook/codebook.cpp:740-761) -> CodewordDistribution
    (codeword_distribution.cpp:349-465) -> Codeword (codeword.cpp:70-83),
    then Voting (voting/voting.cpp:559-614) and the label maps.  The
    keypoint/feature/clustering/ranking components inherit the base
    no-op saveData (utils/json_object.cpp:256-259).

The writer emits library version 17 framing (any >= 6 layout is identical
for the types used); the reader accepts any version and switches the
collection-size width accordingly.  Round-tripped against itself in
the JAX package's tests/test_aux_utils.py and the port's
tests/test_torch_detect_ism.py; byte-layout assumptions are documented above so a
mismatch against a particular boost build is diagnosable.

RISK NOTE: no byte stream from a REAL boost build has been read -- the
environment ships no boost headers, so cross-validation stays blocked;
treat first contact with reference-produced .ismd files as a compatibility
test, not a given.  What IS pinned: the failure-mode contract.  Every read
is bounds-checked and every loop-gating count is validated against the
remaining byte budget, so truncated / bit-flipped / oversized-count /
garbage streams raise a typed ValueError fast -- no hangs, no garbage
output, no struct.error leaks (the JAX package's fuzz suite: tests/test_boost_fuzz.py).

Count-width provenance (verified field-by-field against the reference
source): every map/list in the iSaveData chain writes its count MANUALLY
as a 4-byte int/unsigned (e.g. implicit_shape_model.cpp:1146/1165,
codebook.cpp:742/751, codeword_distribution.cpp:353/366/376,
voting.cpp:562/574/587-598) -- boost's std::map serialization is never
used.  The only boost-STL-serialized members are std::vector<float>/
<unsigned> (codeword.cpp:75 m_data, codeword_distribution.cpp:362-364,
ism_feature.h:30 descriptor) and std::string labels, which take the
8-byte collection_size_type / size_t framing handled by vec_*/string.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

SIGNATURE = b"serialization::archive"
WRITE_VERSION = 17


class BoostBinaryReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.version = self._read_header()

    def _read_header(self) -> int:
        n = self.size_t_raw()
        sig = self.raw(n)
        if sig != SIGNATURE:
            raise ValueError(
                f"not a boost binary archive (signature {sig[:30]!r})")
        (version,) = struct.unpack("<H", self.raw(2))
        return version

    def raw(self, n: int) -> bytes:
        if n < 0:
            raise ValueError(f"archive corrupt (negative byte count {n})")
        b = self.data[self.pos:self.pos + n]
        if len(b) != n:
            raise ValueError("archive truncated")
        self.pos += n
        return b

    def size_t_raw(self) -> int:
        (v,) = struct.unpack("<Q", self.raw(8))
        return v

    def collection_size(self) -> int:
        if self.version >= 6:
            return self.size_t_raw()
        (v,) = struct.unpack("<I", self.raw(4))
        return v

    def u32(self) -> int:
        (v,) = struct.unpack("<I", self.raw(4))
        return v

    def i32(self) -> int:
        (v,) = struct.unpack("<i", self.raw(4))
        return v

    def f32(self) -> float:
        (v,) = struct.unpack("<f", self.raw(4))
        return v

    def count(self, elem_bytes: int = 1, signed: bool = True) -> int:
        """A 4-byte count that gates a read loop: bounds-checked against
        the remaining bytes so a corrupt count raises a typed error
        immediately instead of looping over garbage (fuzz contract,
        tests/test_boost_fuzz.py)."""
        n = self.i32() if signed else self.u32()
        if n < 0 or n * elem_bytes > len(self.data) - self.pos:
            raise ValueError(
                f"archive corrupt (count {n} x {elem_bytes}B exceeds the "
                f"{len(self.data) - self.pos} remaining bytes)")
        return n

    def string(self) -> str:
        n = self.size_t_raw()
        return self.raw(n).decode("utf-8", "replace")

    def vec_f32(self) -> np.ndarray:
        n = self.collection_size()
        return np.frombuffer(self.raw(4 * n), dtype="<f4").copy()

    def vec_u32(self) -> np.ndarray:
        n = self.collection_size()
        return np.frombuffer(self.raw(4 * n), dtype="<u4").copy()


class BoostBinaryWriter:
    def __init__(self):
        self.parts: List[bytes] = []
        self.parts.append(struct.pack("<Q", len(SIGNATURE)))
        self.parts.append(SIGNATURE)
        self.parts.append(struct.pack("<H", WRITE_VERSION))

    def u32(self, v: int):
        self.parts.append(struct.pack("<I", int(v) & 0xFFFFFFFF))

    def i32(self, v: int):
        self.parts.append(struct.pack("<i", int(v)))

    def f32(self, v: float):
        self.parts.append(struct.pack("<f", float(v)))

    def size_t(self, v: int):
        self.parts.append(struct.pack("<Q", int(v)))

    def string(self, s: str):
        b = s.encode("utf-8")
        self.size_t(len(b))
        self.parts.append(b)

    def vec_f32(self, a):
        a = np.asarray(a, "<f4")
        self.size_t(len(a))
        self.parts.append(a.tobytes())

    def vec_u32(self, a):
        a = np.asarray(a, "<u4")
        self.size_t(len(a))
        self.parts.append(a.tobytes())

    def tobytes(self) -> bytes:
        return b"".join(self.parts)


# ---------------------------------------------------------------------------
# .ismd payload model
# ---------------------------------------------------------------------------


@dataclass
class RefCodewordEntry:
    """One CodewordDistribution (codeword_distribution.cpp:349-465)."""
    cw_id: int = 0
    num_features: int = 1
    cw_weight: float = 1.0
    descriptor: np.ndarray = field(default_factory=lambda: np.zeros(1, np.float32))
    cw_class_id: int = -1
    keypoint: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    votes: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    weights: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    class_ids: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint32))
    instance_ids: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint32))
    class_weights: Dict[int, float] = field(default_factory=dict)
    bbox_quats: np.ndarray = field(default_factory=lambda: np.zeros((0, 4), np.float32))
    bbox_sizes: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))


@dataclass
class RefGlobalFeature:
    rf: np.ndarray           # [9]
    descriptor: np.ndarray   # [D]
    radius: float
    instance_id: int


@dataclass
class RefIsmData:
    """Full payload of a reference `.ismd` archive."""
    instance_to_class: Dict[int, int] = field(default_factory=dict)
    distributions: List[RefCodewordEntry] = field(default_factory=list)
    class_sigmas: Dict[int, float] = field(default_factory=dict)
    dims_map: Dict[int, Tuple[float, float]] = field(default_factory=dict)
    variance_map: Dict[int, Tuple[float, float]] = field(default_factory=dict)
    # class id -> list of feature clouds -> list of features
    global_features: Dict[int, List[List[RefGlobalFeature]]] = field(
        default_factory=dict)
    class_labels: List[str] = field(default_factory=list)
    instance_labels: List[str] = field(default_factory=list)


def read_ismd(path: str) -> RefIsmData:
    with open(path, "rb") as f:
        r = BoostBinaryReader(f.read())
    out = RefIsmData()

    # ImplicitShapeModel::iSaveData (implicit_shape_model.cpp:1144-1179)
    for _ in range(r.count(8, signed=False)):
        inst = r.u32()
        cls = r.u32()
        out.instance_to_class[inst] = cls

    # Codebook::iSaveData (codebook.cpp:740-761)
    for _ in range(r.count(40)):
        e = RefCodewordEntry()
        # Codeword::iSaveData (codeword.cpp:70-83)
        e.cw_id = r.i32()
        e.num_features = r.i32()
        e.cw_weight = r.f32()
        e.descriptor = r.vec_f32()
        e.cw_class_id = r.i32()
        e.keypoint = np.array([r.f32(), r.f32(), r.f32()], np.float32)
        nv = r.count(12)
        e.votes = np.array([[r.f32(), r.f32(), r.f32()] for _ in range(nv)],
                           np.float32).reshape(nv, 3)
        e.weights = r.vec_f32()
        e.class_ids = r.vec_u32()
        e.instance_ids = r.vec_u32()
        for _ in range(r.count(8)):
            cid = r.i32()
            e.class_weights[cid] = r.f32()
        nb = r.count(28)
        quats, sizes = [], []
        for _ in range(nb):
            quats.append([r.f32(), r.f32(), r.f32(), r.f32()])
            sizes.append([r.f32(), r.f32(), r.f32()])
        e.bbox_quats = np.asarray(quats, np.float32).reshape(nb, 4)
        e.bbox_sizes = np.asarray(sizes, np.float32).reshape(nb, 3)
        out.distributions.append(e)
    for _ in range(r.count(8)):
        cid = r.i32()
        out.class_sigmas[cid] = r.f32()
    # ActivationStrategy::saveData is the base no-op

    # keypoints / features / global features / clustering: base no-op

    # Voting::iSaveData (voting.cpp:559-614)
    for _ in range(r.count(12, signed=False)):
        cid = r.u32()
        out.dims_map[cid] = (r.f32(), r.f32())
    for _ in range(r.count(12, signed=False)):
        cid = r.u32()
        out.variance_map[cid] = (r.f32(), r.f32())
    for _ in range(r.count(8, signed=False)):
        cid = r.u32()
        clouds = []
        for _ in range(r.count(4, signed=False)):
            feats = []
            for _ in range(r.count(48, signed=False)):
                rf = np.array([r.f32() for _ in range(9)], np.float32)
                desc = r.vec_f32()
                radius = r.f32()
                inst = r.u32()
                feats.append(RefGlobalFeature(rf, desc, radius, inst))
            clouds.append(feats)
        out.global_features[cid] = clouds

    # FeatureRanking: base no-op; label maps (implicit_shape_model.cpp:1165-1179)
    out.class_labels = [r.string() for _ in range(r.u32())]
    out.instance_labels = [r.string() for _ in range(r.u32())]
    return out


def write_ismd(path: str, data: RefIsmData) -> None:
    w = BoostBinaryWriter()
    w.u32(len(data.instance_to_class))
    for inst, cls in data.instance_to_class.items():
        w.u32(inst)
        w.u32(cls)

    w.i32(len(data.distributions))
    for e in data.distributions:
        w.i32(e.cw_id)
        w.i32(e.num_features)
        w.f32(e.cw_weight)
        w.vec_f32(e.descriptor)
        w.i32(e.cw_class_id)
        for v in e.keypoint:
            w.f32(v)
        w.i32(len(e.votes))
        for v in e.votes:
            w.f32(v[0]); w.f32(v[1]); w.f32(v[2])
        w.vec_f32(e.weights)
        w.vec_u32(e.class_ids)
        w.vec_u32(e.instance_ids)
        w.i32(len(e.class_weights))
        for cid, cw in e.class_weights.items():
            w.i32(cid)
            w.f32(cw)
        w.i32(len(e.bbox_quats))
        for q, s in zip(e.bbox_quats, e.bbox_sizes):
            for v in q:
                w.f32(v)
            for v in s:
                w.f32(v)
    w.i32(len(data.class_sigmas))
    for cid, sig in data.class_sigmas.items():
        w.i32(cid)
        w.f32(sig)

    w.u32(len(data.dims_map))
    for cid, (a, b) in data.dims_map.items():
        w.u32(cid); w.f32(a); w.f32(b)
    w.u32(len(data.variance_map))
    for cid, (a, b) in data.variance_map.items():
        w.u32(cid); w.f32(a); w.f32(b)
    w.u32(len(data.global_features))
    for cid, clouds in data.global_features.items():
        w.u32(cid)
        w.u32(len(clouds))
        for feats in clouds:
            w.u32(len(feats))
            for f in feats:
                for v in f.rf:
                    w.f32(v)
                w.vec_f32(f.descriptor)
                w.f32(f.radius)
                w.u32(f.instance_id)

    w.u32(len(data.class_labels))
    for s in data.class_labels:
        w.string(s)
    w.u32(len(data.instance_labels))
    for s in data.instance_labels:
        w.string(s)

    with open(path, "wb") as f:
        f.write(w.tobytes())


# ---------------------------------------------------------------------------
# conversion to / from the framework's TrainedState
# ---------------------------------------------------------------------------


def ref_data_to_state(data: RefIsmData):
    """RefIsmData -> (TrainedState, label_maps) in the framework's padded
    array layout (models/codebook.TrainedCodebook)."""
    from ..models.codebook import TrainedCodebook
    from ..models.ism import TrainedState

    dists = data.distributions
    c_used = len(dists)
    mv = max((len(e.votes) for e in dists), default=1) or 1
    dim = dists[0].descriptor.shape[0] if dists else 1
    num_classes = (max(data.class_sigmas) + 1) if data.class_sigmas else 1

    rows = max(c_used, 1)
    cb = TrainedCodebook(
        codewords=np.zeros((rows, dim), np.float32),
        cw_mask=np.zeros(rows, bool),
        cw_weight=np.ones(rows, np.float32),
        cw_position=np.zeros((rows, 3), np.float32),
        votes=np.zeros((rows, mv, 3), np.float32),
        vote_mask=np.zeros((rows, mv), bool),
        vote_class=np.zeros((rows, mv), np.int32),
        vote_instance=np.zeros((rows, mv), np.int32),
        vote_weight=np.zeros((rows, mv), np.float32),
        class_weight=np.ones((rows, mv), np.float32),
        bbox_size=np.zeros((rows, mv, 3), np.float32),
        bbox_quat=np.zeros((rows, mv, 4), np.float32),
        class_sigma=np.ones(num_classes, np.float32),
    )
    for cid, sig in data.class_sigmas.items():
        cb.class_sigma[cid] = sig
    for i, e in enumerate(dists):
        nv = len(e.votes)
        cb.codewords[i] = e.descriptor
        cb.cw_mask[i] = True
        cb.cw_weight[i] = e.cw_weight
        cb.cw_position[i] = e.keypoint
        cb.votes[i, :nv] = e.votes
        cb.vote_mask[i, :nv] = True
        cb.vote_class[i, :nv] = e.class_ids.astype(np.int32)
        cb.vote_instance[i, :nv] = e.instance_ids.astype(np.int32)
        cb.vote_weight[i, :nv] = e.weights
        cb.class_weight[i, :nv] = [
            e.class_weights.get(int(c), 1.0) for c in e.class_ids]
        cb.bbox_size[i, :nv] = e.bbox_sizes
        cb.bbox_quat[i, :nv] = e.bbox_quats

    g_desc, g_cls, g_inst, g_rad = [], [], [], []
    for cid, clouds in data.global_features.items():
        for feats in clouds:
            for f in feats:
                g_desc.append(f.descriptor)
                g_cls.append(cid)
                g_inst.append(f.instance_id)
                g_rad.append(f.radius)

    state = TrainedState(
        codebook=cb,
        dims_map={int(k): (float(a), float(b))
                  for k, (a, b) in data.dims_map.items()},
        variance_map={int(k): (float(a), float(b))
                      for k, (a, b) in data.variance_map.items()},
        instance_to_class=dict(data.instance_to_class),
        global_descriptors=np.asarray(g_desc, np.float32) if g_desc else None,
        global_classes=np.asarray(g_cls, np.int32) if g_desc else None,
        global_instances=np.asarray(g_inst, np.int32) if g_desc else None,
        global_radii=np.asarray(g_rad, np.float32) if g_desc else None,
    )
    label_maps = {
        "class": {str(i): lbl for i, lbl in enumerate(data.class_labels)},
        "instance": {str(i): lbl
                     for i, lbl in enumerate(data.instance_labels)},
        "usage": "CLASS_PRIMARY" if data.instance_labels else "CLASS_ONLY",
    }
    return state, label_maps


def state_to_ref_data(state, label_maps=None) -> RefIsmData:
    """TrainedState -> RefIsmData (export a framework-trained model for the
    reference implementation to load)."""
    cb = state.codebook
    out = RefIsmData(instance_to_class=dict(state.instance_to_class or {}))
    for i in range(cb.codewords.shape[0]):
        if not cb.cw_mask[i]:
            continue
        nv = int(np.sum(cb.vote_mask[i]))
        cls_ids = np.asarray(cb.vote_class[i, :nv], np.uint32)
        e = RefCodewordEntry(
            cw_id=i,
            num_features=1,
            cw_weight=float(cb.cw_weight[i]),
            descriptor=np.asarray(cb.codewords[i], np.float32),
            cw_class_id=int(cls_ids[0]) if nv else -1,
            keypoint=np.asarray(cb.cw_position[i], np.float32),
            votes=np.asarray(cb.votes[i, :nv], np.float32),
            weights=np.asarray(cb.vote_weight[i, :nv], np.float32),
            class_ids=cls_ids,
            instance_ids=np.asarray(cb.vote_instance[i, :nv], np.uint32),
            class_weights={int(c): float(w) for c, w in zip(
                cls_ids, cb.class_weight[i, :nv])},
            bbox_quats=np.asarray(cb.bbox_quat[i, :nv], np.float32),
            bbox_sizes=np.asarray(cb.bbox_size[i, :nv], np.float32),
        )
        out.distributions.append(e)
    out.class_sigmas = {int(c): float(s)
                        for c, s in enumerate(np.asarray(cb.class_sigma))}
    out.dims_map = dict(state.dims_map)
    out.variance_map = dict(state.variance_map)
    if state.global_descriptors is not None:
        for cid in np.unique(np.asarray(state.global_classes)).tolist():
            sel = np.nonzero(np.asarray(state.global_classes) == cid)[0]
            feats = [RefGlobalFeature(
                rf=np.eye(3, dtype=np.float32).reshape(9),
                descriptor=np.asarray(state.global_descriptors[j], np.float32),
                radius=float(state.global_radii[j]),
                instance_id=int(state.global_instances[j])) for j in sel]
            # one feature cloud per class (the reference appends one cloud
            # per training model; the flat layout is equivalent on load)
            out.global_features[int(cid)] = [feats]
    if label_maps:
        cmap = label_maps.get("class", {})
        out.class_labels = [cmap[str(i)] for i in range(len(cmap))]
        imap = label_maps.get("instance", {})
        out.instance_labels = [imap[str(i)] for i in range(len(imap))]
    return out
