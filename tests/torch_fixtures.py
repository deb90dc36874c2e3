"""Generator of the port's committed fixtures (imports jax).

  point_cloud_donkey_tpu_torch/data/bench_codebook.ism (+ .ismd.npz):
      the bench codebook -- bench.py's config and five training clouds,
      trained by the JAX package on CPU;
  point_cloud_donkey_tpu_torch/data/bench_reference.npz:
      the first N_REF clouds of the bench batch, their labels, and the
      JAX-CPU ``classify_scores_batch`` scores with that codebook.

The machine with the GPU has no JAX, so these files carry the reference
across.  tests/test_torch_fixtures.py regenerates both and checks they
match the committed ones.  Rewrite them with:

    JAX_PLATFORMS=cpu python tests/torch_fixtures.py
"""

import os
import sys
import tempfile

import numpy as np

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_TESTS, os.path.dirname(_TESTS)]

from bench_data import (BENCH_CONFIG, KEYPOINT_CAPACITY,  # noqa: E402
                        NUM_CLASSES, bench_clouds)

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "point_cloud_donkey_tpu_torch", "data")
CODEBOOK = os.path.join(DATA_DIR, "bench_codebook.ism")
REFERENCE = os.path.join(DATA_DIR, "bench_reference.npz")
N_REF = 16


def jax_pipeline_config():
    """bench.py's JitPipelineConfig (bench.py:219-228)."""
    from point_cloud_donkey_tpu.models.pipeline_jit import JitPipelineConfig
    return JitPipelineConfig(
        descriptor="SHOT", radius=0.6, ref_frame_radius=0.5, leaf_size=0.35,
        normal_radius=0.25, normals_method=2, metric="chisq", knn_k=1,
        keypoint_capacity=KEYPOINT_CAPACITY, neighbor_capacity=896,
        bandwidth=0.5, num_classes=NUM_CLASSES, fused_descriptor=True)


def build_codebook(path: str) -> None:
    """Train the bench model with the JAX package and save it at `path`
    (+ `path`d.npz)."""
    from point_cloud_donkey_tpu.models.ism import ImplicitShapeModel
    from point_cloud_donkey_tpu.utils.config import IsmConfig
    from point_cloud_donkey_tpu.utils.io import PointCloud, save_pcd

    ism = ImplicitShapeModel(IsmConfig.from_json(BENCH_CONFIG))
    train, labels, _, _ = bench_clouds(0)
    with tempfile.TemporaryDirectory() as tmp:
        for cid, pts in zip(labels, train):
            p = os.path.join(tmp, f"t{cid}.pcd")
            save_pcd(p, PointCloud(xyz=pts))
            ism.add_training_model(p, int(cid), int(cid))
        ism.train()
    ism.save(path)


def jax_scores(codebook_path: str, points: np.ndarray,
               mask: np.ndarray) -> np.ndarray:
    """JAX-CPU classify_scores_batch scores [B, C] with the bench config."""
    import jax
    import jax.numpy as jnp
    from point_cloud_donkey_tpu.models.codebook import (CodebookParams,
                                                        TrainedCodebook)
    from point_cloud_donkey_tpu.models.pipeline_jit import \
        classify_scores_batch

    with np.load(codebook_path + "d.npz") as z:
        cb = TrainedCodebook(**{k[3:]: jnp.asarray(z[k]) for k in z.files
                                if k.startswith("cb_")})
    cfg = jax_pipeline_config()
    params = CodebookParams(knn_k=1)
    step = jax.jit(lambda p, m: classify_scores_batch(p, m, cb, cfg,
                                                      params)[0])
    return np.asarray(step(jnp.asarray(points), jnp.asarray(mask)))


def build_reference(codebook_path: str, path: str) -> None:
    _, _, clouds, labels = bench_clouds(N_REF)
    mask = np.ones(clouds.shape[:2], bool)
    scores = jax_scores(codebook_path, clouds, mask)
    np.savez_compressed(path, points=clouds, labels=labels.astype(np.int32),
                        scores=scores.astype(np.float32))


def main() -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    os.makedirs(DATA_DIR, exist_ok=True)
    build_codebook(CODEBOOK)
    build_reference(CODEBOOK, REFERENCE)
    print(f"wrote {CODEBOOK}(d.npz) and {REFERENCE}")


if __name__ == "__main__":
    main()
