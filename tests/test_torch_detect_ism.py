"""Detection through the port's ImplicitShapeModel against the JAX
package on the CPU:

  * ``load`` of the committed models gives the JAX package's states, and
    the detection models carry the shipped configs;
  * the voting stage (the batched mean-shift, the maxima, the global
    verification with CSHOT_GLOBAL + SVM, filters, merge and selection) on
    the JAX cast votes committed in data/detect_reference.npz, against the
    JAX maxima committed beside them -- the default.ism, quickstart.ism
    and Hough3D + RANSAC + Merge detections of chip_smoke.py's phase 10,
    on their first clouds -- to the contracts of
    tests/bench_data.maxima_mismatches; the same votes through the JAX
    package's own voting stage give the committed maxima;
  * ``detect_batch``, ``detect`` and ``detect_file`` end to end on four
    small scenes against the JAX package's ``detect_batch`` (dense
    descriptors): the firm detections (bench_data.firm_mismatches),
    detect and detect_file equal to their row of detect_batch bit for
    bit, two runs equal, no kernel launched for CPU tensors, the
    voting-space dump;
  * ``save_reference`` -> ``load`` against the JAX package, both ways;
  * a scene above the (patched) scene threshold and VoxelGridCulling
    detect as the JAX package does; each remaining refusal names its
    queue;
  * ``eval_detection`` end to end as the JAX package's
    tests/test_detection.py drives its CLI, with summary.txt and the
    per-cloud log in the JAX CLI's format.

The JAX references compute the SHOT family densely on the CPU
(torch_fixtures.dense_descriptors), the formulation the port computes."""

import json
import os
import re

import numpy as np
import pytest
import torch

import shapes
from bench_data import (DETECT_SCALES, HOUGH_VOTING, LIMIT_SEEDS,
                        detect_inputs, firm_mismatches, maxima_mismatches,
                        unpack_maxima, unpack_votes, with_voting)
from torch_fixtures import (CODEBOOK, CODEBOOKS, DETECT_MODELS,
                            DETECT_REFERENCE, LIMITS_REFERENCE,
                            dense_descriptors, jax_detector)

from point_cloud_donkey_tpu.cli.eval_detection import main as jax_eval
from point_cloud_donkey_tpu.models.ism import ImplicitShapeModel as JaxIsm
from point_cloud_donkey_tpu.utils.io import PointCloud, save_pcd
from point_cloud_donkey_tpu_torch import eval_detection
from point_cloud_donkey_tpu_torch.kernels import build
from point_cloud_donkey_tpu_torch.models.codebook import CastVotes
from point_cloud_donkey_tpu_torch.models.ism import (ImplicitShapeModel,
                                                     _voting_params)
from point_cloud_donkey_tpu_torch.utils.config import IsmConfig
from point_cloud_donkey_tpu_torch.utils.io import save_pcd as port_save_pcd

CPU = torch.device("cpu")
MODELS = {"default": DETECT_MODELS["default"],
          "quickstart": DETECT_MODELS["quickstart"],
          "bench": CODEBOOK, "short_shot": CODEBOOKS["SHORT_SHOT"]}
# clouds of detect_reference.npz whose voting stage the tests repeat
VOTING_CLOUDS = {"default": 2, "quickstart": 4, "hough": 4}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_load_matches_jax(name):
    got = ImplicitShapeModel.load(MODELS[name], device="cpu").state
    want = JaxIsm.load(MODELS[name]).state
    for k, v in want.codebook._asdict().items():
        np.testing.assert_array_equal(getattr(got.codebook, k),
                                      np.asarray(v), err_msg=k)
    assert got.dims_map == want.dims_map
    assert got.variance_map == want.variance_map
    assert got.instance_to_class == want.instance_to_class
    for k in ("global_descriptors", "global_classes", "global_instances",
              "global_radii"):
        a, b = getattr(got, k), getattr(want, k)
        assert (a is None) == (b is None)
        if b is not None:
            np.testing.assert_array_equal(a, b)
    assert (got.svm is None) == (want.svm is None)
    if want.svm is not None:
        ga, wa = got.svm.to_arrays(), want.svm.to_arrays()
        assert sorted(ga) == sorted(wa)
        for k in wa:
            np.testing.assert_array_equal(ga[k], wa[k], err_msg=k)
    if name == "default":
        assert want.svm is not None and want.global_descriptors is not None


@pytest.mark.parametrize("name", ["default", "quickstart"])
def test_detection_models_are_the_shipped_configs(name):
    """The committed JAX-trained models carry configs/<name>.ism as
    shipped."""
    from torch_fixtures import shipped_config
    assert IsmConfig.load(DETECT_MODELS[name]).to_json() == \
        IsmConfig.from_json(shipped_config(name)).to_json()


def port_detector(name: str) -> ImplicitShapeModel:
    """The port's ImplicitShapeModel of phase 10's detection `name`, on
    the CPU."""
    if name == "hough":
        ism = ImplicitShapeModel.load(CODEBOOK, device="cpu")
        with open(CODEBOOK) as f:
            ism.config = IsmConfig.from_json(with_voting(json.load(f),
                                                         HOUGH_VOTING))
        return ism
    return ImplicitShapeModel.load(DETECT_MODELS[name], device="cpu")


@pytest.fixture(scope="module")
def reference():
    with np.load(DETECT_REFERENCE) as z:
        return dict(z)


def reference_case(reference, name, count, seed=7):
    """(clouds, colours or None, votes as CastVotes, maxima) of the first
    `count` clouds of a phase-10 detection (on the scenes of `seed`)."""
    clouds, rgbs = detect_inputs(name, seed)
    pre = f"{name}_vote_"
    votes = unpack_votes({k[len(pre):]: v for k, v in reference.items()
                          if k.startswith(pre)})[:count]
    pre = f"{name}_max_"
    maxima = unpack_maxima({k[len(pre):]: v for k, v in reference.items()
                            if k.startswith(pre)})[:count]
    cast = [CastVotes(valid=np.ones(len(v["weight"]), bool), **{
        k: a.astype(np.int64 if k in ("class_id", "instance_id")
                    else np.float32) for k, a in v.items()}) for v in votes]
    return (clouds[:count], None if rgbs is None else rgbs[:count], cast,
            maxima)


def voting_stage(ism, clouds, rgbs, votes):
    """The maxima of each cloud from its cast votes: the batched mean-shift
    and each cloud's _finish_detect, as detect_batch runs them."""
    vparams = _voting_params(ism.config.child("Voting"))
    pre = ism._precompute_mean_shift_batch(votes, vparams)
    return [ism._finish_detect(votes[i], clouds[i], None,
                               None if rgbs is None else rgbs[i], vparams,
                               None, pre[i]) for i in range(len(votes))]


@pytest.mark.parametrize("name", sorted(VOTING_CLOUDS))
def test_voting_stage_matches_reference(reference, name):
    clouds, rgbs, votes, want = reference_case(reference, name,
                                               VOTING_CLOUDS[name])
    got = voting_stage(port_detector(name), clouds, rgbs, votes)
    assert sum(len(m) for m in want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        bad = maxima_mismatches(g, w, DETECT_SCALES[name])
        assert not bad, (i, bad)
    # the committed maxima are today's JAX voting stage on those votes
    jax_ism = jax_detector(name)
    with dense_descriptors():
        again = voting_stage(jax_ism, clouds[:1], None if rgbs is None
                             else rgbs[:1], votes[:1])
    assert not maxima_mismatches(again[0], want[0], DETECT_SCALES[name])


@pytest.mark.parametrize("seed", LIMIT_SEEDS)
def test_limits_reference_voting_stage(seed):
    """data/detect_limits_reference.npz at one of its seeds: every scene
    has its maxima, the JAX voting stage on the first default scene's
    committed votes gives its committed maxima, and the port's meets the
    maxima contracts."""
    with np.load(LIMITS_REFERENCE) as z:
        ref = {k[len(f"s{seed}_"):]: v for k, v in z.items()
               if k.startswith(f"s{seed}_")}
    for name in ("default", "hough"):
        assert len(ref[f"{name}_max_count"]) == len(detect_inputs(name,
                                                                  seed)[0])
    clouds, rgbs, votes, want = reference_case(ref, "default", 1, seed)
    assert want[0]
    got = voting_stage(port_detector("default"), clouds, rgbs, votes)
    assert not maxima_mismatches(got[0], want[0], DETECT_SCALES["default"])
    with dense_descriptors():
        again = voting_stage(jax_detector("default"), clouds, rgbs, votes)
    assert not maxima_mismatches(again[0], want[0],
                                 DETECT_SCALES["default"])


SCENE_VOTING = {"Parameters": {"SingleObjectMode": False,
                               "MaxFilterType": "Merge",
                               "AverageRotation": True,
                               "MinVotesThreshold": 2}}


@pytest.fixture(scope="module")
def small_scenes():
    """Four scenes of four 512-point bench objects, the bench SHOT model
    detecting several objects a scene (merged maxima, averaged rotations),
    and the JAX package's detect_batch of them."""
    from bench_data import bench_scenes
    clouds, _, _ = bench_scenes(4, n=512, seed=12)
    with open(CODEBOOK) as f:
        cfg = with_voting(json.load(f), SCENE_VOTING)
    jax_ism = JaxIsm.load(CODEBOOK)
    from point_cloud_donkey_tpu.utils.config import IsmConfig as JaxConfig
    jax_ism.config = JaxConfig.from_json(cfg)
    with dense_descriptors():
        want = [m for m, _ in jax_ism.detect_batch(list(clouds))]
    return clouds, cfg, want


def test_detect_batch_matches_jax(small_scenes, tmp_path):
    clouds, cfg, want = small_scenes
    cfg = json.loads(json.dumps(cfg))
    cfg["ObjectConfig"]["Parameters"].update(
        EnableVotingAnalysis=True,
        VotingAnalysisOutputPath=str(tmp_path / "votes"))
    ism = ImplicitShapeModel.load(CODEBOOK, device="cpu")
    ism.config = IsmConfig.from_json(cfg)
    build.reset_launch_counts()
    got = ism.detect_batch(list(clouds))
    assert set(build.launch_counts().values()) == {0}
    bandwidth = ism.config.child("Voting").get("Bandwidth", 0.1)
    for (g, times), w in zip(got, want):
        assert not firm_mismatches(g, w, bandwidth), \
            firm_mismatches(g, w, bandwidth)
    for k in ("complete", "features", "flann", "voting", "maxima"):
        assert times[k] > 0, (k, times)
    dumps = sorted(os.listdir(tmp_path / "votes"))
    assert len(dumps) == len(clouds)
    with np.load(tmp_path / "votes" / dumps[0]) as z:
        assert len(z["votes"]) == len(z["weights"]) > 0
    again = ism.detect_batch(list(clouds))
    one = ism.detect(clouds[1])[0]
    for (a, _), (b, _) in zip(got, again):
        assert_bit_equal(a, b)
    assert_bit_equal(one, got[1][0])
    path = str(tmp_path / "scene.pcd")
    port_save_pcd(path, clouds[1], binary=True)
    assert_bit_equal(ism.detect_file(path)[0], one)


def assert_bit_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for f in ("class_id", "instance_id", "weight", "instance_weight",
                  "num_votes", "glob_class_id", "glob_class_weight"):
            assert getattr(x, f) == getattr(y, f), f
        for f in ("position", "bb_size", "bb_quat"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))


def test_save_reference_round_trip(tmp_path):
    """The port's save_reference loads in the port and in the JAX package
    as the same state; the JAX package's save_reference loads in the
    port as it does in the JAX package."""
    port = ImplicitShapeModel.load(DETECT_MODELS["default"], device="cpu")
    port.save_reference(str(tmp_path / "p.ism"))
    jax_ism = JaxIsm.load(DETECT_MODELS["default"])
    jax_ism.save_reference(str(tmp_path / "j.ism"))
    assert not os.path.exists(tmp_path / "p.ismd.npz")
    for path in ("p.ism", "j.ism"):
        got = ImplicitShapeModel.load(str(tmp_path / path), device="cpu")
        want = JaxIsm.load(str(tmp_path / path))
        for k, v in want.state.codebook._asdict().items():
            np.testing.assert_array_equal(getattr(got.state.codebook, k),
                                          np.asarray(v), err_msg=k)
        assert got.state.dims_map == want.state.dims_map
        np.testing.assert_array_equal(got.state.global_descriptors,
                                      want.state.global_descriptors)
        assert got.label_maps == want.label_maps
    orig = port.state.codebook
    used = orig.cw_mask
    back = ImplicitShapeModel.load(str(tmp_path / "p.ism"),
                                   device="cpu").state.codebook
    np.testing.assert_array_equal(back.codewords, orig.codewords[used])
    np.testing.assert_array_equal(back.votes[back.vote_mask],
                                  orig.votes[used][orig.vote_mask[used]])


REFUSALS = {
    "global_cgf": ({"Children": {
        "GlobalFeatures": {"Type": "CGF", "Parameters": {}},
        "Voting": {"Parameters": {"UseGlobalFeatures": True}}}},
        "global features"),
}


def _changed_config(cfg: dict, change: dict) -> dict:
    """`cfg` with each child of `change` given its Type and Parameters."""
    for child, node in change.get("Children", {}).items():
        base = cfg["ObjectConfig"]["Children"].setdefault(child, {})
        if "Type" in node:
            base["Type"] = node["Type"]
        base.setdefault("Parameters", {}).update(node.get("Parameters", {}))
    return cfg


@pytest.mark.parametrize("case", sorted(REFUSALS) + ["observers"])
def test_unsupported_detection_is_refused(case):
    ism = ImplicitShapeModel.load(CODEBOOK, device="cpu")
    if case == "observers":
        with pytest.raises(NotImplementedError, match="A13"):
            ism.connect(print)
        return
    change, reason = REFUSALS[case]
    ism.config = IsmConfig.from_json(_changed_config(ism.config.to_json(),
                                                     change))
    cloud = np.random.default_rng(0).uniform(-1, 1, (600, 3)).astype(
        np.float32)
    build.reset_launch_counts()
    with pytest.raises(NotImplementedError, match=reason):
        ism.detect_batch([cloud])


# what the port refused before it computed CGF (ROADMAP A15.5) and the
# LRF variants (A15.6); tests/test_torch_cgf.py and
# test_torch_lrf_variants.py hold them against the JAX package
FORMERLY_REFUSED = {
    "detector_keypoints": {"Children": {
        "Keypoints": {"Type": "ISS3D", "Parameters": {
            "SalientRadius": 0.2, "NonMaxRadius": 0.1, "MinNeighbors": 5}},
        "Features": {"Type": "CGF", "Parameters": {}}}},
    "descriptor": {"Children": {"Features": {
        "Type": "CGF", "Parameters": {"Radius": 0.6}}}},
    "whole_cloud_globals": {"Children": {
        "GlobalFeatures": {"Type": "USC_GLOBAL", "Parameters": {
            "Radius": 0.3, "ReferenceFrameRadius": 2.0,
            "ReferenceFrameType": "BOARD"}},
        "Voting": {"Parameters": {"UseGlobalFeatures": True}}}},
}


@pytest.mark.parametrize("case", sorted(FORMERLY_REFUSED))
def test_formerly_refused_detection_runs(case, tmp_path):
    """The bench model's config under each change trains on two shapes
    and detects the first: its class on top, no kernel launched on the
    CPU."""
    cfg = _changed_config(ImplicitShapeModel.load(
        CODEBOOK, device="cpu").config.to_json(), FORMERLY_REFUSED[case])
    ism = ImplicitShapeModel(IsmConfig.from_json(cfg), "cpu")
    rng = np.random.default_rng(3)
    clouds = [shapes.make_instance(rng, c, n=1024, noise=0.005).astype(
        np.float32) for c in (0, 1)]
    for c, xyz in enumerate(clouds):
        path = str(tmp_path / f"m{c}.pcd")
        port_save_pcd(path, xyz)
        ism.add_training_model(path, c, c)
    ism.train()
    dim = 1980 if case == "whole_cloud_globals" else 32
    if case == "whole_cloud_globals":
        assert ism.state.global_descriptors.shape[1] == dim
    else:
        assert ism.state.codebook.codewords.shape[1] == dim
    build.reset_launch_counts()
    maxima, times = ism.detect_batch([clouds[0]])[0]
    assert set(build.launch_counts().values()) == {0}
    assert maxima and maxima[0].class_id == 0 and times["complete"] > 0


def _bench_detector(cfg):
    """(port, JAX) ImplicitShapeModels of the bench SHOT model under the
    config `cfg`."""
    from point_cloud_donkey_tpu.utils.config import IsmConfig as JaxConfig
    jax_ism = JaxIsm.load(CODEBOOK)
    jax_ism.config = JaxConfig.from_json(cfg)
    ism = ImplicitShapeModel.load(CODEBOOK, device="cpu")
    ism.config = IsmConfig.from_json(cfg)
    return ism, jax_ism


def test_scene_scale_detection_matches_jax(monkeypatch):
    """A scene above the scene threshold (patched to 512 in both packages,
    the chunks to 64) detects on the scene route: the firm detections of
    the JAX package's scene route (bench_data.firm_mismatches), detect()
    equal to detect_batch bit for bit."""
    from bench_data import bench_scenes
    from point_cloud_donkey_tpu.ops import tiled as jt
    from point_cloud_donkey_tpu_torch.ops import tiled as tt
    for mod in (jt, tt):
        monkeypatch.setattr(mod, "SCENE_TILE_THRESHOLD", 512)
        monkeypatch.setattr(mod, "NORMALS_CHUNK", 64)
        monkeypatch.setattr(mod, "KEYPOINT_CHUNK", 64)
    clouds, _, _ = bench_scenes(1, n=512, seed=13)
    with open(CODEBOOK) as f:
        cfg = with_voting(json.load(f), SCENE_VOTING)
    ism, jax_ism = _bench_detector(cfg)
    with dense_descriptors():
        want = jax_ism.detect(clouds[0])[0]
    got = ism.detect_batch([clouds[0]])[0][0]
    bandwidth = ism.config.child("Voting").get("Bandwidth", 0.1)
    assert want and not firm_mismatches(got, want, bandwidth), \
        firm_mismatches(got, want, bandwidth)
    assert_bit_equal(ism.detect(clouds[0])[0], got)


def test_culling_detection_matches_jax():
    """VoxelGridCulling (Curvature, CutOff 0.5, RequireCombinedList with
    ColorDistance, refined positions) at detection, on the batched
    route of both packages, on a coloured 8192-point scene (phase 10's
    hough scenes' density: sparser objects leave ill-posed normals that
    move descriptors): the firm detections of the JAX package's."""
    from bench_data import bench_scenes
    clouds, rgbs, _ = bench_scenes(1, n=2048, seed=12)
    with open(CODEBOOK) as f:
        cfg = with_voting(json.load(f), SCENE_VOTING)
    cfg["ObjectConfig"]["Children"]["Keypoints"] = {
        "Type": "VoxelGridCulling",
        "Parameters": {"LeafSize": 0.35, "FilterMethodGeometry": "Curvature",
                       "FilterTypeGeometry": "CutOff",
                       "FilterMethodColor": "ColorDistance",
                       "FilterTypeColor": "CutOff",
                       "MaxSimilarColorDistance": 0.05,
                       "FilterCutoffRatio": 0.5,
                       "CombineFilters": "RequireCombinedList",
                       "RefineKeypointPosition": True}}
    ism, jax_ism = _bench_detector(cfg)
    with dense_descriptors():
        want = [m for m, _ in jax_ism.detect_batch(list(clouds), None,
                                                   list(rgbs))]
    got = [m for m, _ in ism.detect_batch(list(clouds), None, list(rgbs))]
    bandwidth = ism.config.child("Voting").get("Bandwidth", 0.1)
    for g, w in zip(got, want):
        assert w and not firm_mismatches(g, w, bandwidth), \
            firm_mismatches(g, w, bandwidth)
    assert_bit_equal(ism.detect(clouds[0], None, rgbs[0])[0], got[0])


def _detection_files(tmp_path, rng):
    """The JAX package's tests/test_detection.py data: two isolated
    objects a class (box, torus) for training, one scene of both."""
    config = {"ObjectConfig": {
        "Children": {
            "Clustering": {"Type": "None"},
            "Codebook": {"Children": {"ActivationStrategy": {
                "Parameters": {"K": 1}, "Type": "KNN"}}},
            "FeatureWeighting": {"Type": "Uniform"},
            "Features": {"Parameters": {"Radius": 0.6,
                                        "ReferenceFrameRadius": 0.5},
                         "Type": "SHORT_SHOT"},
            "GlobalFeatures": {"Type": "Dummy"},
            "Keypoints": {"Parameters": {"LeafSize": 0.3},
                          "Type": "VoxelGrid"},
            "Voting": {"Parameters": {
                "Bandwidth": 0.6, "SingleObjectMode": False,
                "MinThreshold": -0.5, "MaxFilterType": "Merge",
                "MinVotesThreshold": 3}, "Type": "MeanShift"}},
        "Parameters": {"DistanceType": "ChiSquared",
                       "BoundingBoxType": "AABB",
                       "DistanceThresholdDetection": 0.8}}}
    cfg = str(tmp_path / "config.ism")
    with open(cfg, "w") as f:
        json.dump(config, f)
    train = ["# train detection"]
    for cid, name in [(1, "box"), (2, "torus")]:
        for j in range(2):
            p = str(tmp_path / f"train_{name}_{j}.pcd")
            save_pcd(p, PointCloud(xyz=shapes.make_instance(
                rng, cid, n=900, rotate=False)))
            train.append(f"{p} {name}")
    (tmp_path / "train.txt").write_text("\n".join(train) + "\n")
    box = shapes.make_instance(rng, 1, n=900, rotate=False)
    torus = shapes.make_instance(rng, 2, n=900, rotate=False) + [4.0, 0, 0]
    scene = str(tmp_path / "scene.pcd")
    save_pcd(scene, PointCloud(xyz=np.concatenate([box, torus]).astype(
        np.float32)))
    ann = str(tmp_path / "scene_ann.txt")
    with open(ann, "w") as f:
        for name, pts in (("box", box), ("torus", torus)):
            c = pts.mean(0)
            f.write(f"{name} (0.0) {c[0]} {c[1]} {c[2]}\n")
    (tmp_path / "test.txt").write_text(f"# test detection\n{scene} {ann}\n")
    return cfg


def test_eval_detection_matches_jax(tmp_path):
    """eval_detection -t (training list) then -d (test list), the port's
    CLI on the CPU beside the JAX package's on the same files: summary.txt
    equal line for line but for its two timing lines, and the per-cloud
    log's header and rows in the same format with the same classes."""
    cfg = _detection_files(tmp_path, np.random.default_rng(0))
    flist, tlist = str(tmp_path / "train.txt"), str(tmp_path / "test.txt")
    with dense_descriptors():
        assert jax_eval(["-t", cfg, "-f", flist,
                         "-o", str(tmp_path / "jax")]) == 0
        assert jax_eval(["-d", str(tmp_path / "jax.ism"), "-f", tlist,
                         "-o", str(tmp_path / "jax_out")]) == 0
    assert eval_detection.main(["-t", cfg, "-f", flist, "-o",
                                str(tmp_path / "port"),
                                "--device", "cpu"]) == 0
    assert eval_detection.main(["-d", str(tmp_path / "port.ism"), "-f",
                                tlist, "-o", str(tmp_path / "port_out"),
                                "--device", "cpu"]) == 0
    got = (tmp_path / "port_out" / "summary.txt").read_text().splitlines()
    want = (tmp_path / "jax_out" / "summary.txt").read_text().splitlines()
    assert got[:-2] == want[:-2]
    assert got[-2].startswith("complete time: ")
    assert got[-1].startswith("total processing time: ")
    m = re.search(r"mean recall:\s+([0-9.]+)", "\n".join(got))
    assert m and float(m.group(1)) >= 0.5
    log = (tmp_path / "port_out" / "scene.pcd.txt").read_text().splitlines()
    jlog = (tmp_path / "jax_out" / "scene.pcd.txt").read_text().splitlines()
    assert log[0] == jlog[0].replace(str(tmp_path / "jax.ism"),
                                     str(tmp_path / "port.ism"))
    assert log[1] == jlog[1]
    assert len(log) == len(jlog) >= 3
    for a, b in zip(log[2:], jlog[2:]):
        ta, tb = a.split(", "), b.split(", ")
        assert len(ta) == len(tb) == 16
        assert ta[:2] == tb[:2] and ta[3] == tb[3]
