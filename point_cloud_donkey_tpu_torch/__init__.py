"""point_cloud_donkey_tpu_torch: the PyTorch/CUDA port of the SHOT
classification serving path of point_cloud_donkey_tpu.

The JAX package beside it is the reference.  Module names mirror it one to
one (``ops/eigh3.py`` <-> ``point_cloud_donkey_tpu/ops/eigh3.py``).  Plain
tensor code is PyTorch; the four hot loops of the path are CUDA kernels
written for Hopper (``csrc/``), bound through a plain C interface
(``kernels/build.py``) and wrapped in ``ops/kernels/``.  Each wrapper runs
its plain PyTorch twin for CPU tensors and launches its kernel for CUDA
tensors -- there is no fallback from one to the other.

The package imports torch and numpy and nothing of jax or of the JAX
package: the host modules it needs (``utils/config.py``, ``utils/io.py``)
are ported too.
"""

__version__ = "0.1.0"
