"""kdtreepathtraceroptimization_tpu_torch — the path tracer in PyTorch and CUDA.

A port of ``kdtreepathtraceroptimization_tpu`` (JAX, TPU) to PyTorch on an
NVIDIA H100. It keeps the JAX package's layout and names (``config``,
``scene/``, ``ops/``, ``render/``, ``models/``, ``utils/``) and draws the
same random streams, so one scene renders to the same image in both
packages up to float summation order.

It renders meshes through every mesh route of the JAX package's dispatch:
the pair list (the default config from 1,024 triangles, with either pair
kernel: ``pair_bdiag``), every KD walk (the fat-row skip-link walk is the
default below that; the short-stack, packet and thin-table walks on
request), the exact cluster walk, cluster rounds, the binned intersector
and the two brute forces, with the wavefront reorderings and the ray
cache. Its front end is the command line (``python -m
kdtreepathtraceroptimization_tpu_torch.cli SCENE.txt [MESH.obj]``) with the
film checkpoints and image files. It differentiates the render with
respect to the material table, the camera and the mesh's triangle tables
(``models.inverse``: ``render_loss``, ``make_train_step``), and on the KD
route with respect to the vertex positions and the camera, visibility
edges included (``ops.edgegrad.make_render_geo``). Its thirteen kernels,
one for each TPU kernel of the JAX package and one for the analytic
geoms' nearest hit, are CUDA C++ written for Hopper (``csrc/``), each with
a plain PyTorch version beside it that runs on CPU tensors.

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
