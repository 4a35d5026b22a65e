"""kdtreepathtraceroptimization_tpu_torch — the path tracer in PyTorch and CUDA.

A port of ``kdtreepathtraceroptimization_tpu`` (JAX, TPU) to PyTorch on an
NVIDIA H100. It keeps the JAX package's layout and names (``config``,
``scene/``, ``ops/``, ``render/``, ``utils/``) and draws the same random
streams, so one scene renders to the same image in both packages up to
float summation order.

This slice runs the exact cluster-walk render path (``cluster=True,
cluster_walk=True, cluster_pairs=False``) end to end. Its three kernels
are CUDA C++ written for Hopper (``csrc/``), each with a plain PyTorch
version beside it that runs on CPU tensors. Configurations outside the
slice raise ``NotImplementedError``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without CUDA they raise instead of falling back.
"""

__version__ = "0.1.0"

from kdtreepathtraceroptimization_tpu_torch.config import RenderConfig  # noqa: F401
