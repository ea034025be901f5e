"""The host data plane (C++): parallel round packing, the f32 -> bf16 cast
and the tensor store with its unix-socket server; the port of
``kubeml_tpu/native``.

``csrc/kubeml_native.cpp`` is built with the host C++ compiler at first
use (:mod:`.build`); :mod:`.bindings` is the Python surface and
:mod:`.weights` the weight exchange of standalone job runners. Without a
compiler every surface runs on its Python fallback, counted and logged.
"""

from .bindings import (  # noqa: F401
    TensorClient,
    TensorServer,
    TensorStore,
    f32_to_bf16,
    fallback_counts,
    get_lib,
    native_available,
    pack_rounds,
)

__all__ = [
    "TensorClient",
    "TensorServer",
    "TensorStore",
    "f32_to_bf16",
    "fallback_counts",
    "get_lib",
    "native_available",
    "pack_rounds",
]
