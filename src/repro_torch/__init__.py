"""repro_torch — X-TIME (CAM-based tree-ensemble inference) on PyTorch + CUDA.

The port of the JAX package ``repro`` to one NVIDIA H100, grown slice by
slice beside it (ROADMAP.md).  It imports ``torch`` and never ``jax`` or
anything of ``repro``; artifacts are exchanged through the shared on-disk
format.  It carries the main path: compiled artifact -> engine -> Hopper
CAM-match kernel -> ``predict``, and in the soft cell mode
``predict_proba`` and the leaf-spread uncertainty.

    repro_torch.api      ``build`` -> ``CompiledModel`` (save/load/predict)
    repro_torch.convert  artifact state <-> the port's ``CompiledModel``
    repro_torch.core     trees, compiler, placement, NoC/perf models,
                         precision cells, defect injection and the
                         single-device engine
    repro_torch.kernels  table prep, the plain PyTorch version and the
                         CUDA kernels (``kernels/csrc/cam_match.cu``,
                         ``kernels/csrc/cam_match_soft.cu``)

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from repro_torch.api import CompiledModel, build
from repro_torch.core.deploy import DeployConfig
from repro_torch.core.engine import XTimeEngine

__all__ = ["CompiledModel", "DeployConfig", "XTimeEngine", "build"]
