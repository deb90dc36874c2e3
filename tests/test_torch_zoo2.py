"""The rest of the descriptor zoo's local types through the port's
ImplicitShapeModel against the JAX package's on the CPU: training and
detect_batch with BSHOT, SHORT_SHOT_PCL, SpinImage, PFH, 3DSC, USC, RSD
(both UseFullRSDHistogram modes), RoPS, COSPAIR, RIFT, ESF_LOCAL and GASD
as the local feature (tests/test_torch_zoo2_global.py: NARF, the
whole-cloud globals, USC_GLOBAL and RIFT on the scene route).

Each configuration is the bench config (tests/bench_data.BENCH_CONFIG)
with its Features swapped, trained on 4 coloured 1024-point models of 2
classes and detecting 3 fresh views (ESF_LOCAL with LeafSize 0.8: its
20000 line samples a keypoint make the CPU reference slow; RoPS under
Euclidean distances, TRAININGS says why; chip_smoke.py's phase 13 holds
RoPS under ChiSquared without the class sigma).

Contracts: the training contract of tests/test_torch_train.py (the same
codeword count and vote structure, >= 97% of the codewords at cosine >
0.999); detection: the firm detections of tests/bench_data.
firm_mismatches against the JAX package's detect_batch of its own model.
The JAX references run in subprocesses (tests/jax_jobs.py), queued when
the module starts."""

import copy
from types import SimpleNamespace

import numpy as np
import pytest

import shapes
from bench_data import (BENCH_CONFIG, FIRM_RTOL, bench_colors,
                        firm_mismatches, unpack_maxima)
from jax_jobs import JaxPool
from test_torch_train import assert_codebooks_match
from point_cloud_donkey_tpu_torch.kernels import build
from point_cloud_donkey_tpu_torch.models.ism import ImplicitShapeModel
from point_cloud_donkey_tpu_torch.utils.config import IsmConfig
from point_cloud_donkey_tpu_torch.utils.io import read_cloud, save_pcd

N_POINTS = 1024


def zoo2_config(features: dict, keypoints: dict = None,
                params: dict = None) -> dict:
    """The bench config with Features `features` (and Keypoints'
    parameters `keypoints`, the root's `params`)."""
    cfg = copy.deepcopy(BENCH_CONFIG)
    ch = cfg["ObjectConfig"]["Children"]
    ch["Features"]["Type"] = features["Type"]
    ch["Features"]["Parameters"].update(features.get("Parameters", {}))
    ch["Keypoints"]["Parameters"].update(keypoints or {})
    cfg["ObjectConfig"]["Parameters"].update(params or {})
    return cfg


TRAININGS = {
    "bshot": zoo2_config({"Type": "BSHOT"}),
    "short_shot_pcl": zoo2_config({"Type": "SHORT_SHOT_PCL"}),
    "spin_image": zoo2_config({"Type": "SpinImage"}),
    "pfh": zoo2_config({"Type": "PFH"}),
    "3dsc": zoo2_config({"Type": "3DSC"}),
    "usc": zoo2_config({"Type": "USC"}),
    "rsd": zoo2_config({"Type": "RSD"}),
    "rsd_min_max": zoo2_config({"Type": "RSD", "Parameters": {
        "UseFullRSDHistogram": False}}),
    # RoPS's moments take either sign: under ChiSquared a term whose a + b
    # lies at the rounding of 0 takes any size, and the class sigma (the
    # variance of every feature-codeword distance) with it
    "rops": zoo2_config({"Type": "RoPS"}, params={"DistanceType":
                                                  "Euclidean"}),
    "cospair": zoo2_config({"Type": "COSPAIR"}),
    "rift": zoo2_config({"Type": "RIFT"}),
    "esf_local": zoo2_config({"Type": "ESF_LOCAL"}, {"LeafSize": 0.8}),
    "gasd_local": zoo2_config({"Type": "GASD"}),
}


@pytest.fixture(scope="module")
def zoo_files(tmp_path_factory):
    """4 coloured training models of 2 classes and 3 fresh views, as PCD
    files: ([(path, class)], [path])."""
    tmp = tmp_path_factory.mktemp("zoo2_models")
    rng = np.random.default_rng(23)
    files, views = [], []
    for i in range(7):
        pts = shapes.make_instance(rng, i % 2, n=N_POINTS, rotate=True,
                                   noise=0.005).astype(np.float32)
        path = str(tmp / f"c{i}.pcd")
        save_pcd(path, pts, rgb=bench_colors(pts))
        if i < 4:
            files.append((path, i % 2))
        else:
            views.append(path)
    return files, views


@pytest.fixture(scope="module")
def jax_refs(zoo_files):
    """The JAX trainings and detections of TRAININGS, queued at once."""
    files, views = zoo_files
    pool = JaxPool(4)
    jobs = {name: pool.call("zoo_jobs:train_detect", cfg=cfg,
                            files=[list(f) for f in files],
                            detect_files=views)
            for name, cfg in TRAININGS.items()}
    yield jobs
    pool.close()


def port_train(files, cfg):
    ism = ImplicitShapeModel(IsmConfig.from_json(cfg), "cpu")
    for path, cid in files:
        ism.add_training_model(path, cid, cid)
    ism.train()
    return ism


def assert_detections_match(ism, views, ref):
    """detect_batch of the views: the firm detections of the JAX
    package's."""
    clouds = [read_cloud(v) for v in views]
    build.reset_launch_counts()
    got = [m for m, _ in ism.detect_batch([c.xyz for c in clouds], None,
                                          [c.rgb for c in clouds])]
    assert set(build.launch_counts().values()) == {0}
    want = unpack_maxima({k[4:]: v for k, v in ref.items()
                          if k.startswith("max_")})
    bw = ism.config.child("Voting").get("Bandwidth", 0.1)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert not firm_mismatches(g, w, bw, FIRM_RTOL), i
    return got


@pytest.mark.parametrize("name", sorted(TRAININGS))
def test_local_type_trains_and_detects_as_jax(zoo_files, jax_refs, name):
    """Training: the codebook contract; detect_batch of the 3 views: the
    firm detections of JAX's."""
    files, views = zoo_files
    ism = port_train(files, TRAININGS[name])
    want = jax_refs[name].result()
    assert_codebooks_match(ism.state.codebook, SimpleNamespace(**{
        k[3:]: v for k, v in want.items() if k.startswith("cb_")}))
    if name == "bshot":
        assert set(np.unique(ism.state.codebook.codewords)) <= {0.0, 1.0}
    got = assert_detections_match(ism, views, want)
    print(f"{name}: {len(ism.state.codebook.codewords)} codewords, "
          f"maxima {[len(g) for g in got]}")
