"""Host-side utilities of the port (``ocm_tpu/utils``'s counterparts):
the native C++ core (``native``), synthetic data (``synthetic``), data and
artifact I/O (``io``), outlier removal (``outliers``), object-aware splits
(``splits``), checkpoints (``checkpoint``), profiling (``profiling``),
plots (``report``) and the msgpack model-file format (``msgpack_io``).

The submodules load on first access (``ocm_tpu_torch.utils.io``), so that
importing one of them never imports the others: ``ops.linalg`` reaches
``native`` and ``outliers`` reaches ``ops.linalg``.
"""

import importlib

__all__ = ["checkpoint", "io", "msgpack_io", "native", "outliers",
           "profiling", "report", "splits", "synthetic"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
