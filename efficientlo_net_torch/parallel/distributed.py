"""Process groups, host-sharded evaluation and the port's collectives.

The port's copy of ``efficientlo_net_tpu/parallel/distributed.py`` on
``torch.distributed``: one process per device, started by ``torchrun``
(which sets ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK``) or by any launcher that gives ``initialize_distributed`` a
coordinator, the world size and the rank.  Evaluation splits
its sequences round-robin over the processes and all-reduces the metric.

The collectives below take a process group (``None``: the default group).
NCCL reduces CUDA tensors only, so a CPU tensor given with an NCCL group is
copied to the current card and back; gloo takes CPU tensors and, for
``all_reduce`` and ``broadcast``, CUDA tensors too.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
) -> bool:
    """Join the default process group of a multi-process run.

    ``coordinator_address`` ("host:port") is where rank 0 holds the
    rendezvous; without it the environment's ``MASTER_ADDR`` and
    ``MASTER_PORT`` (set by ``torchrun``) are used.  ``num_processes`` and
    ``process_id`` default to ``WORLD_SIZE`` (else 1) and ``RANK`` (else 0).
    With neither a coordinator nor ``MASTER_ADDR`` this does nothing and
    returns False (a run of one process).  The backend is NCCL for a CUDA
    ``device`` (whose current card becomes ``LOCAL_RANK``, else the rank
    modulo the cards) and gloo for the CPU.  Returns True once joined."""
    if coordinator_address is None and "MASTER_ADDR" not in os.environ:
        return False
    world = num_processes if num_processes is not None else int(os.environ.get("WORLD_SIZE", "1"))
    rank = process_id if process_id is not None else int(os.environ.get("RANK", "0"))
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    init = "env://" if coordinator_address is None else f"tcp://{coordinator_address}"
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=init,
                            world_size=world, rank=rank)
    return True


def process_index(group=None) -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def process_count(group=None) -> int:
    """The number of processes (1 without a process group)."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def shard_sequences_by_host(sequences: Sequence[int], process_id: Optional[int] = None,
                            num_processes: Optional[int] = None) -> List[int]:
    """Round-robin split of evaluation sequences over the processes."""
    pid = process_index() if process_id is None else process_id
    n = process_count() if num_processes is None else num_processes
    return [s for i, s in enumerate(sequences) if i % n == pid]


def aggregate_mean_t_rel(local_results: Dict[int, object], group=None) -> float:
    """The validation scalar over every process's sequences: each adds its
    (sum of t_rel, count) and all read back the global mean."""
    local_sum = float(np.sum([r.t_rel for r in local_results.values()])) if local_results else 0.0
    totals = torch.tensor([local_sum, float(len(local_results))], dtype=torch.float64)
    if process_count(group) > 1:
        all_reduce_(totals, group)
    return float(totals[0] / max(float(totals[1]), 1.0))


def _comm_tensor(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` itself, or a copy on the current card where the group is NCCL
    and ``t`` lies on the CPU."""
    if not t.is_cuda and dist.get_backend(group) == dist.Backend.NCCL:
        return t.to(torch.device("cuda", torch.cuda.current_device()))
    return t


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """In-place sum of ``t`` over the group; returns ``t``."""
    work = _comm_tensor(t, group)
    dist.all_reduce(work, group=group)
    if work is not t:
        t.copy_(work)
    return t


def broadcast_(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """In place: ``t`` takes the value of the group's rank ``src`` (a rank
    within ``group``); returns ``t``."""
    work = _comm_tensor(t, group)
    global_src = src if group is None else dist.get_global_rank(group, src)
    dist.broadcast(work, global_src, group=group)
    if work is not t:
        t.copy_(work)
    return t


def broadcast_object(obj, src: int = 0, group=None):
    """Rank ``src``'s picklable ``obj`` on every rank of the group."""
    box = [obj]
    global_src = src if group is None else dist.get_global_rank(group, src)
    dist.broadcast_object_list(box, global_src, group=group)
    return box[0]


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group whose backward sums the gradients over the group
    too: every rank's output depends on every rank's input."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable sum of ``x`` over the group (a new tensor)."""
    return _AllReduceSum.apply(x, group)
