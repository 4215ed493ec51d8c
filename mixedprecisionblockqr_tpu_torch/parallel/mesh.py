"""Device meshes over ``torch.distributed`` (port of
``mixedprecisionblockqr_tpu/parallel/mesh.py``).

Every distributed entry point agrees on two axis names:

  * ``rows``  -- the long (row) dimension of tall matrices is split here;
    the TSQR tree rides this axis;
  * ``batch`` -- independent problems split here.

The JAX package writes its distributed programs as ``shard_map`` bodies.
Here they are SPMD code: every rank of the process group runs the same
function on its own slab, and the collectives below take the places of
``jax.lax.all_gather`` and ``psum``.  The caller starts the process group
before building a mesh, as with any ``torch.distributed`` program: with
``torchrun``, or in each process with ``init_process_group(backend,
store=..., rank=..., world_size=...)``.  A mesh lives on the card
(``device_type='cuda'``, NCCL, one rank per GPU) unless the caller asks
for ``'cpu'`` (gloo).

Entry points take the global array on every rank and return this rank's
slab of a sharded result and the whole of a replicated one.
``gather_rows`` / ``gather_cols`` rebuild a global array from the slabs.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

ROWS_AXIS = "rows"
BATCH_AXIS = "batch"

# torch >= 2.12 names the flat all-gather ``all_gather_single`` and
# deprecates ``all_gather_into_tensor``; older releases have only the latter.
_all_gather_flat = getattr(dist, "all_gather_single",
                           dist.all_gather_into_tensor)


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = (ROWS_AXIS,),
    device_type: Optional[str] = None,
):
    """A ``DeviceMesh`` over the ranks of the started process group;
    default a 1-D mesh over all of them on the ``rows`` axis.
    ``device_type`` defaults to ``'cuda'``; without a CUDA device that
    raises, unless the caller passes ``'cpu'``."""
    from torch.distributed.device_mesh import init_device_mesh

    if device_type is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: make_mesh builds a mesh on the GPU by "
                "default; pass device_type='cpu' (gloo) to run on the CPU")
        device_type = "cuda"
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a started process group: run under torchrun, "
            "or call torch.distributed.init_process_group(backend, "
            "store=..., rank=..., world_size=...) in every process first")
    world = dist.get_world_size()
    if shape is None:
        shape = (world,)
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {tuple(shape)} != {world} devices")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh, axis: str) -> int:
    """Ranks along ``axis`` (the JAX package's ``mesh.shape[axis]``)."""
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def axis_index(mesh, axis: str) -> int:
    """This rank's position along ``axis`` (``jax.lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def row_sharding(mesh, axis: str = ROWS_AXIS):
    """Placements of an array whose rows split over ``axis`` (the JAX
    package's ``P(axis, None)``): ``Shard(0)`` on that mesh dimension,
    ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(0) if name == axis else Replicate()
                 for name in mesh.mesh_dim_names)


def replicated(mesh):
    """Placements of an array every rank holds whole (``P()``)."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axis`` (``jax.lax.psum``), reduced
    in place: pass a tensor the caller does not need afterwards.  Every
    rank calls it with the same shape; an empty tensor is returned as
    is."""
    if x.numel():
        x = x.contiguous()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    return x


def all_gather(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The ``x`` of every rank of ``axis``, stacked on a new leading
    dimension in rank order (``jax.lax.all_gather``)."""
    group = mesh.get_group(axis)
    x = x.contiguous()
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],)
                      + tuple(x.shape[1:]))
    _all_gather_flat(out, x, group=group)
    return out.reshape((-1,) + tuple(x.shape))


def shard_rows(x: torch.Tensor, mesh, axis: str = ROWS_AXIS
               ) -> torch.Tensor:
    """This rank's row slab of the global ``x`` (rows split evenly over
    ``axis``), contiguous, on the mesh's device."""
    d = axis_size(mesh, axis)
    m = x.shape[0]
    if m % d:
        raise ValueError(f"rows {m} must divide over mesh axis {axis} ({d})")
    h = m // d
    i = axis_index(mesh, axis)
    return x[i * h:(i + 1) * h].to(mesh_device(mesh)).contiguous()


def gather_rows(x_loc: torch.Tensor, mesh, axis: str = ROWS_AXIS
                ) -> torch.Tensor:
    """The global array whose row slabs over ``axis`` are the ranks'
    ``x_loc`` (the inverse of ``shard_rows``)."""
    return all_gather(x_loc, mesh, axis).reshape(
        (-1,) + tuple(x_loc.shape[1:]))


def gather_cols(x_loc: torch.Tensor, mesh, axis: str = ROWS_AXIS
                ) -> torch.Tensor:
    """The global (m x d*c) array whose column slabs over ``axis`` are the
    ranks' (m x c) ``x_loc`` (the JAX package's ``P(None, axis)``)."""
    parts = all_gather(x_loc, mesh, axis)
    return torch.cat(list(parts), dim=1)
