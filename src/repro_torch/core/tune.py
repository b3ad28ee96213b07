"""Kernel-version naming of the autotuner (``repro.core.tune``).

Only ``kernel_version`` is ported: serving and scoring reports name the
kernel a binding runs.  The autotuner itself (``autotune_kernel``,
``TunePlan``) is a later slice (ROADMAP.md); until then an artifact's
``tuning`` is carried through save/load and applied nowhere.
"""

from __future__ import annotations

import numpy as np


def kernel_version(table_dtype: str) -> str:
    """Kernel generation a resolved table dtype binds: the v1 int32
    exclusive-high layout, the v2 packed inclusive-high layout
    (uint8/uint16), or the float32 soft-encoded layout ('soft')."""
    if table_dtype == "int32":
        return "v1"
    return "soft" if np.dtype(table_dtype).kind == "f" else "v2"
