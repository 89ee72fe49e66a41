"""Production and host meshes: ``DeviceMesh`` with the reference's axis
names, ``data`` (DP + FSDP), ``model`` (TP/EP/SP) and ``pod`` (pure DP
across pods).

Functions, never module-level meshes: importing this module starts no
process group.  ``make_production_mesh`` needs one of 256 (or 512) ranks
already initialised; the dry run starts a fake one
(``launch/dryrun.py``).  ``MeshLayout`` carries a mesh's axis names and
sizes with no process group at all, which is all spec resolution reads
(``sharding/policies.py``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def production_shape(multi_pod: bool = False):
    """((16, 16), ("data", "model")) or ((2, 16, 16), ("pod", "data",
    "model"))."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """A mesh's shape and axis names (``DeviceMesh.shape`` and
    ``.mesh_dim_names``) without devices or process group."""

    shape: tuple
    mesh_dim_names: tuple

    @property
    def ndim(self) -> int:
        return len(self.shape)


def production_layout(multi_pod: bool = False) -> MeshLayout:
    return MeshLayout(*production_shape(multi_pod))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16×16 (256 ranks) or 2×16×16 (512 ranks) over the initialised
    process group.  Raises, as the reference does, when the world is
    smaller than the mesh."""
    shape, axes = production_shape(multi_pod)
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n:
        raise RuntimeError(
            f"need {n} ranks, have {have}: initialise a process group of "
            f"{n} ranks first (launch/dryrun.py starts a fake one)")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh() -> DeviceMesh:
    """Degenerate 1×1 ``("data", "model")`` mesh on the current card, over
    an initialised process group of one rank."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised process "
                           "group (world size 1)")
    if not torch.cuda.is_available():
        raise RuntimeError("make_host_mesh needs a CUDA device")
    return DeviceMesh("cuda", torch.tensor([[dist.get_rank()]]),
                      mesh_dim_names=("data", "model"))
