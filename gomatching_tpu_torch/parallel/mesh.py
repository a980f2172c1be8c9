"""Data-parallel groups on ``torch.distributed`` (port of ``gomatching_tpu/parallel/mesh.py``).

The reference's only parallelism is DDP over GPUs (train_net.py:186-209). The JAX package
realizes it as one ``('data', 'model')`` mesh whose 'data' axis shards whole clips
(training) or frame batches (inference), XLA inserting the collectives. The port runs one
process per card (``parallel/launch.py``) and issues the collectives itself:

  - ``mesh_shape``: the mesh arithmetic of JAX ``build_mesh`` (``TPU.MESH_DATA`` -1 = every
    remaining device on the data axis; ``TPU.MESH_MODEL``), with its assert;
  - ``all_reduce_mean_``: the gradient (and loss) average of a step over ONE flat buffer,
    after ``backward()`` and before the global-norm clip, JAX's order (``pmean`` of the
    gradients, then the ``tx`` chain);
  - ``gather_shapes`` / ``gather_objects``: host-side gathers (every rank's clip size, the
    spot rows of a sharded batch), over gloo, which has no CUDA ``all_gather``.

No ``DistributedDataParallel``: the trainer calls the spot and the head separately, the
spot is detached and the trainable spotter tensors get zero gradients the trainer fills
in after ``backward()``, which DDP's reducer would only see after its hooks had fired.
"""

from __future__ import annotations

import datetime
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600  # a collective that waits longer fails the rank

_HOST_GROUPS: Dict = {}  # host_group's gloo group for each NCCL group


def mesh_shape(cfg=None, world: int = 1) -> Tuple[int, int]:
    """(data, model) sizes of JAX ``build_mesh(cfg)`` over ``world`` devices: without a
    cfg every device on 'data'; ``TPU.MESH_MODEL`` (at least 1) on 'model' and
    ``TPU.MESH_DATA`` on 'data', <= 0 meaning ``world // model``. Raises as JAX asserts
    when the two do not multiply to ``world``."""
    model, data = 1, world
    if cfg is not None:
        model = max(int(cfg.TPU.MESH_MODEL), 1)
        data = int(cfg.TPU.MESH_DATA)
        if data <= 0:
            data = world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} devices")
    return data, model


def init_distributed(backend: str, init_method: str, world_size: int, rank: int,
                     timeout_s: float = DEFAULT_TIMEOUT_S):
    """Join the default process group; returns it."""
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return dist.group.WORLD


def rank_and_world(group=None) -> Tuple[int, int]:
    """(rank, world size) in ``group``; (0, 1) without a process group."""
    if group is None and not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def is_main(group=None) -> bool:
    """Rank 0 of ``group`` (every process is, outside a process group): the one that
    writes files."""
    return rank_and_world(group)[0] == 0


def host_group(group=None):
    """A gloo group over the ranks of ``group`` for host-side gathers: ``group`` itself
    when its backend is gloo, else one gloo group made at the first call for ``group``
    and returned by every later one (every rank of ``group`` makes its first call at the
    same point, as ``new_group`` requires)."""
    if dist.get_backend(group) == "gloo":
        return group
    group = group or dist.group.WORLD
    if group not in _HOST_GROUPS:
        _HOST_GROUPS[group] = dist.new_group(ranks=dist.get_process_group_ranks(group),
                                             backend="gloo")
    return _HOST_GROUPS[group]


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Average ``tensors`` in place over the ranks of ``group`` through ONE flat buffer
    (one collective a step). On a gloo group CUDA tensors are reduced through a host
    copy. Every rank gets the same bits."""
    tensors = list(tensors)
    if not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    staged = flat.cpu() if dist.get_backend(group) == "gloo" and flat.is_cuda else flat
    dist.all_reduce(staged, group=group)
    staged /= dist.get_world_size(group)
    if staged is not flat:
        flat.copy_(staged)
    pos = 0
    with torch.no_grad():
        for t in tensors:
            n = t.numel()
            t.copy_(flat[pos:pos + n].view_as(t))
            pos += n


def gather_objects(obj, group=None) -> List:
    """Every rank's ``obj`` (picklable), in rank order, on every rank."""
    _, world = rank_and_world(group)
    out: List = [None] * world
    dist.all_gather_object(out, obj, group=group)
    return out


def gather_shapes(shape: Sequence[int], group=None) -> List[Tuple[int, ...]]:
    """Every rank's clip shape (T, h, w), in rank order, on every rank."""
    return [tuple(int(v) for v in s) for s in gather_objects(tuple(shape), group)]

