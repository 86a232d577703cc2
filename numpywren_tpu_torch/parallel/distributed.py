"""Multi-process execution: one process per device, joined by torch.distributed.

Counterpart of numpywren_tpu/parallel/distributed.py. JAX runs one process
per host and its coordination service joins them; PyTorch runs one process
per device, every rank running the same script:

    from numpywren_tpu_torch.parallel import distributed, make_mesh, sharded_cholesky
    distributed.initialize()            # NPW_* or torchrun's variables
    mesh = make_mesh()                  # spans every rank
    ... sharded_cholesky(a, tile, mesh) ...

Pass coordinator/num_processes/process_id, or set NPW_COORDINATOR
(host:port of rank 0) / NPW_NUM_PROCESSES / NPW_PROCESS_ID; with none of
them, torchrun's RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT are read
(SLURM's SLURM_PROCID / SLURM_NTASKS with MASTER_ADDR / MASTER_PORT
exported). The backend is "cpu:gloo,cuda:nccl" on a host with a card and
"gloo" without one; ``backend=`` chooses another. Each rank takes the card
LOCAL_RANK (else its rank) modulo the host's card count, unless
``local_device_ids`` names one. All module functions are no-ops in a plain
single-process run (process_count() == 1), so library code does not need
to branch.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

# the dtypes broadcast_from_host0 sends, by their index in this tuple
_DTYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16, torch.int64,
           torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool, torch.complex64,
           torch.complex128)


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids=None,
               backend: Optional[str] = None) -> bool:
    """Join the default process group (idempotent).

    Argument resolution order: explicit args, NPW_COORDINATOR /
    NPW_NUM_PROCESSES / NPW_PROCESS_ID env vars, then the launcher's
    variables (torchrun, or SLURM with MASTER_ADDR / MASTER_PORT). Returns
    True when running multi-process after the call, False for a plain
    single-process run (nothing configured anywhere). Collective: every
    rank calls it."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator = coordinator or os.environ.get("NPW_COORDINATOR")
    if num_processes is None and os.environ.get("NPW_NUM_PROCESSES"):
        num_processes = int(os.environ["NPW_NUM_PROCESSES"])
    if process_id is None and os.environ.get("NPW_PROCESS_ID"):
        process_id = int(os.environ["NPW_PROCESS_ID"])
    auto = coordinator is None and num_processes is None and process_id is None
    if auto:
        found = _launcher_env()
        if found is None:
            return False  # single process, nothing to join
        coordinator, num_processes, process_id = found
    elif coordinator is None or num_processes is None or process_id is None:
        raise ValueError("initialize needs coordinator, num_processes and process_id together "
                         f"(got {coordinator!r}, {num_processes!r}, {process_id!r})")
    if torch.cuda.is_available():
        if local_device_ids is not None:
            ids = [local_device_ids] if isinstance(local_device_ids, int) else list(local_device_ids)
            torch.cuda.set_device(ids[0])
        else:
            local = int(os.environ.get("LOCAL_RANK", process_id))
            torch.cuda.set_device(local % torch.cuda.device_count())
    if backend is None:
        backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes), rank=int(process_id))
    return dist.get_world_size() > 1


def _launcher_env():
    """(coordinator, world size, rank) from torchrun's or SLURM's variables,
    or None when neither launched this process. A SLURM job without
    MASTER_ADDR / MASTER_PORT warns and runs single-process, loudly: on a
    real multi-node job that is wrong."""
    env = os.environ
    addr, port = env.get("MASTER_ADDR"), env.get("MASTER_PORT")
    if env.get("RANK") is not None and env.get("WORLD_SIZE") is not None and addr and port:
        return f"{addr}:{port}", int(env["WORLD_SIZE"]), int(env["RANK"])
    if env.get("SLURM_PROCID") is not None and env.get("SLURM_NTASKS") is not None:
        if addr and port:
            return f"{addr}:{port}", int(env["SLURM_NTASKS"]), int(env["SLURM_PROCID"])
        logging.getLogger(__name__).warning(
            "SLURM job without MASTER_ADDR/MASTER_PORT: continuing single-process. On a "
            "multi-node job this is wrong: export them or pass coordinator/num_processes/"
            "process_id explicitly.")
    return None


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_multi_host() -> bool:
    return process_count() > 1


def sync(name: str = "npw_sync") -> None:
    """Barrier across all ranks (no-op single-process). Collective. `name`
    is kept for the reference's signature; torch's barrier has none."""
    if is_multi_host():
        dist.barrier()


def _comm_device(x=None) -> torch.device:
    """Where a collective's buffer lives: a tensor's own device, else the
    CPU unless the default group has no CPU backend."""
    if isinstance(x, torch.Tensor):
        return x.device
    if "gloo" in dist.get_backend() or not torch.cuda.is_available():
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def broadcast_from_host0(x):
    """Replicate process 0's `x` (an ndarray or a tensor) to every process:
    its dtype and shape go first, so the other ranks' `x` only says where
    the result lives (a tensor's device; an ndarray comes back as one).
    No-op single-process. Collective."""
    if not is_multi_host():
        return x
    dev = _comm_device(x)
    if dist.get_rank() == 0:
        t = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
        head = torch.tensor([_DTYPES.index(t.dtype), t.dim(), *t.shape], dtype=torch.int64)
        head = torch.cat([head, torch.zeros(10 - head.numel(), dtype=torch.int64)])
    else:
        head = torch.zeros(10, dtype=torch.int64)
    head = head.to(dev)
    dist.broadcast(head, src=0)
    code, ndim, *dims = head.tolist()
    if dist.get_rank() == 0:
        buf = t.to(dev).contiguous()
    else:
        buf = torch.empty(dims[:ndim], dtype=_DTYPES[code], device=dev)
    dist.broadcast(buf, src=0)
    return buf if isinstance(x, torch.Tensor) else buf.cpu().numpy()


def host_local_array(local_data, global_shape, sharding) -> DTensor:
    """Assemble a global sharded array from each rank's own block (a
    NamedSharding of parallel.mesh; DTensor.from_local with the global shape
    and stride): the multi-process way to bind matrices too large for any
    one host. Each rank passes exactly its block; no data moves."""
    from numpywren_tpu_torch.parallel.mesh import as_dtensor, local_box, mesh_device

    box = local_box(global_shape, sharding)
    want = tuple(s for _, s in box)
    loc = torch.as_tensor(np.asarray(local_data)) if not isinstance(local_data, torch.Tensor) \
        else local_data
    if tuple(loc.shape) != want:
        raise ValueError(f"rank {process_index()}: local block {tuple(loc.shape)} where the "
                         f"sharding gives {want} of {tuple(global_shape)}")
    return as_dtensor(loc.to(mesh_device(sharding.mesh)), global_shape, sharding)


def full_tensor(x: DTensor) -> torch.Tensor:
    """The global value of a sharded DTensor on every rank of its mesh, on
    the local device, assembled with one all_reduce per mesh axis (each
    group of replicas adds its block once), the collectives every backend
    takes for a CUDA tensor. Collective over the mesh."""
    from numpywren_tpu_torch.parallel.mesh import (NamedSharding, box_slices, is_primary,
                                                   local_box, sum_over_mesh)

    sh = NamedSharding(x.device_mesh, tuple(x.placements))
    loc = x.to_local()
    out = torch.zeros(tuple(x.shape), dtype=loc.dtype, device=loc.device)
    if is_primary(sh):
        out[box_slices(local_box(x.shape, sh))] = loc
    return sum_over_mesh(out, x.device_mesh)


def gather_to_hosts(x) -> np.ndarray:
    """Fetch an array as a full numpy array on every process: a DTensor's
    global value; a plain array or tensor, every process's one concatenated
    along axis 0 in rank order (0-d ones stacked). For results small enough
    to replicate: factors, residuals, test assertions. Collective."""
    if isinstance(x, DTensor):
        return full_tensor(x).cpu().numpy()
    if not is_multi_host():
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if isinstance(x, torch.Tensor):
        t = x
    else:
        t = torch.as_tensor(np.asarray(x)).to(_comm_device())
    t = t.reshape(1) if t.dim() == 0 else t
    out = torch.zeros((process_count(),) + tuple(t.shape), dtype=t.dtype, device=t.device)
    out[process_index()] = t
    dist.all_reduce(out)
    return out.reshape((-1,) + tuple(t.shape[1:])).cpu().numpy()
