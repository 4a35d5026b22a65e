"""kdtreepathtraceroptimization_tpu_torch — the path tracer in PyTorch and CUDA.

A port of ``kdtreepathtraceroptimization_tpu`` (JAX, TPU) to PyTorch on an
NVIDIA H100. It keeps the JAX package's layout and names (``config``,
``scene/``, ``ops/``, ``render/``, ``models/``, ``utils/``) and draws the
same random streams, so one scene renders to the same image in both
packages up to float summation order.

It renders meshes through the pair list (the default config), the exact
cluster walk and the two brute forces, and differentiates the render with
respect to the material table, the camera and the mesh's triangle tables
(``models.inverse``: ``render_loss``, ``make_train_step``). Its seven
kernels are CUDA C++ written for Hopper (``csrc/``), each with a plain
PyTorch version beside it that runs on CPU tensors. Configurations outside
the port raise ``NotImplementedError``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without CUDA they raise instead of falling back.
"""

__version__ = "0.1.0"

from kdtreepathtraceroptimization_tpu_torch.config import RenderConfig  # noqa: F401
from kdtreepathtraceroptimization_tpu_torch.models.inverse import (  # noqa: F401
    TrainState,
    make_train_step,
    render_loss,
)
