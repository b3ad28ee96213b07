"""repro_torch — X-TIME (CAM-based tree-ensemble inference) on PyTorch + CUDA.

The port of the JAX package ``repro`` to one NVIDIA H100, grown slice by
slice beside it (ROADMAP.md).  It imports ``torch`` and never ``jax`` or
anything of ``repro``; artifacts are exchanged through the shared on-disk
format.  It carries the main path: a model in (a dump file, a trained
ensemble or a hardware-aware search), then lowering, compile and
compression, then engine -> Hopper CAM-match kernel -> ``predict``, and in
the soft cell mode
``predict_proba`` and the leaf-spread uncertainty; on top of the engine,
the serving tier (``TableRegistry`` -> ``MicroBatcher`` -> ``ServeLoop``,
and the replicated ``ClusterServer``), streaming ``score_file`` and the
``TraversalBaseline`` the paper compares against; the kernel autotuner
(``autotune_kernel`` -> ``TunePlan`` -> ``CompiledModel.with_tuning``),
the ``ingest`` and ``score`` command lines (``repro_torch.cli``), the
multi-device engine (``mesh=`` on the engine, the artifact, the serving
tier and ``score_file``), and checkpoint and restart.

    repro_torch.api      ``build`` -> ``CompiledModel`` (save/load/predict)
    repro_torch.convert  artifact state <-> the port's ``CompiledModel``
    repro_torch.ingest   XGBoost JSON / LightGBM text / sklearn-forest
                         importers and the lowering onto a bin grid
    repro_torch.core     trees and their trainers, the hardware-aware
                         search, compiler, compression, placement,
                         NoC/perf models, precision cells, defect
                         injection, the engine (one device or a mesh)
                         and the traversal baseline
    repro_torch.data     the synthetic tabular datasets (Table II analogs)
    repro_torch.kernels  table prep, the plain PyTorch version and the
                         CUDA kernels (``kernels/csrc/cam_match.cu``,
                         ``kernels/csrc/cam_match_soft.cu``)
    repro_torch.serve    registry, micro-batching, the serving loop, the
                         async cluster and traffic replay
    repro_torch.score    streaming offline scoring of columnar files
    repro_torch.launch   device meshes (``make_host_mesh``; logical shards
                         may share one device)
    repro_torch.checkpoint  atomic, async checkpoints in the JAX package's
                         format
    repro_torch.ft       heartbeats, straggler detection and the
                         checkpoint/restart runner
    repro_torch.cli      ``python -m repro_torch.cli.ingest`` / ``.score``

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from repro_torch.api import CompiledModel, build
from repro_torch.core.baselines import TraversalBaseline
from repro_torch.core.deploy import DeployConfig
from repro_torch.core.engine import XTimeEngine
from repro_torch.core.tune import TunePlan, autotune_kernel
from repro_torch.score import score_file
from repro_torch.serve import ClusterServer, ServeLoop, TableRegistry

__all__ = [
    "ClusterServer", "CompiledModel", "DeployConfig", "ServeLoop", "TableRegistry",
    "TraversalBaseline", "TunePlan", "XTimeEngine", "autotune_kernel", "build",
    "score_file",
]
