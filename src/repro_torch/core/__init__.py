"""Host-side model, compiler and engine of the port (see repro_torch).

``TunePlan`` and ``autotune_kernel`` resolve lazily (PEP 562), as in
``repro.core``: ``core.tune`` pulls in the engine and the training stack,
which import this package back.
"""

_LAZY = {
    "TunePlan": "repro_torch.core.tune",
    "autotune_kernel": "repro_torch.core.tune",
}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        value = getattr(importlib.import_module(_LAZY[name]), name)
        globals()[name] = value  # cache: next access skips this hook
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
