"""Multi-process start-up for training and serving.  Port of
cosyvoice_tpu/parallel/distributed.py.

The JAX package starts jax.distributed and then sees every device of the
cluster in one program.  The port runs one process a rank: `init` joins the
torch.distributed process group, from the explicit (coordinator_address,
num_processes, process_id) triple or from torchrun's environment
(MASTER_ADDR / MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK).

The backend, logged and returned, never chosen behind the caller's back:
- `gloo` on the CPU;
- `nccl` when every rank of a host has a card of its own;
- `gloo` over CUDA tensors when ranks share a card (NCCL refuses two ranks
  on one device).  The port's collectives are all-reduce and broadcast
  only, which gloo runs on CUDA tensors.
"""
from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


def choose_backend(device_type: str, local_world: int) -> str:
    """gloo on the CPU or when `local_world` ranks share fewer cards; nccl
    when each rank of the host has a card of its own."""
    if device_type != "cuda":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= local_world else "gloo"


def local_device(device=None) -> torch.device:
    """The rank's device: `device` if given (a CPU run), else
    cuda:{LOCAL_RANK % device_count} (ranks beyond the host's cards share
    them)."""
    if device is not None and torch.device(device).type != "cuda":
        return torch.device(device)
    if device is not None and torch.device(device).index is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                           "the plain PyTorch versions on the CPU")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                        % torch.cuda.device_count())


def init(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
         process_id: Optional[int] = None, backend: Optional[str] = None,
         device_type: str = "cuda") -> Optional[str]:
    """Join the process group when running more than one process.

    Resolution: the explicit triple (coordinator "host:port" or a
    "tcp://" / "file://" URL), else torchrun's environment.  Returns the
    backend when a multi-process group was started (or already exists), and
    None for a single process, as the JAX package's init returns False.
    A second call is a no-op."""
    if dist.is_initialized():
        return dist.get_backend()
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if (num_processes or 1) <= 1:
        return None
    if coordinator_address is None or process_id is None:
        raise ValueError("more than one process needs a coordinator address and a "
                         "process id (or torchrun's MASTER_ADDR / MASTER_PORT / RANK)")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    local_world = int(env.get("LOCAL_WORLD_SIZE", num_processes))
    backend = backend or choose_backend(device_type, local_world)
    if device_type == "cuda" and backend == "nccl":
        torch.cuda.set_device(local_device())
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id)
    logger.info("torch.distributed: rank %d/%d, backend %s", process_id, num_processes,
                backend)
    return backend


def rank_and_world() -> tuple[int, int]:
    """(rank, world size) of the process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1
