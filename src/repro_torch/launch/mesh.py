"""Device meshes over a process group the caller has set up.

Port of ``repro/launch/mesh.py``: functions, not module-level constants, so
importing this module touches no device or process-group state.  The caller
initialises ``torch.distributed`` first (``torchrun``, or
``init_process_group`` with its own backend, rank and world size), as JAX's
caller sets up its devices; the mesh is then one ``DeviceMesh`` over every
rank of that group, its dims named as the reference's axes.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(shape, axes, device_type: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` (e.g. (2, 4), ("data", "model") over
    8 ranks) on ``device_type`` ("cuda", or "cpu" for a gloo world)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed "
                           "process group (init_process_group, or torchrun)")
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The reference's production meshes: (16, 16) data x model, or
    (2, 16, 16) pod x data x model with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)
