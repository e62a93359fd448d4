"""Data parallelism over ``torch.distributed``: the counterpart of
``mlic_tpu/parallel/mesh.py``.

The JAX package runs one program over a device mesh, the batch sharded
and the parameters replicated, and XLA inserts the gradient's all-reduce.
The reference runs DDP over NCCL (``MLIC++/playground/train.py:96-106``).
The port runs one process a card, as torchrun starts them: each process
holds the whole model, takes its slice of the global batch
(``local_batch_slice``) and averages its gradients with the others' by one
all-reduce of a flat buffer (``all_reduce_mean_``), at the points of the
training steps where the JAX step's mean over the sharded batch falls
(``train/trainer.apply_gradients``, ``train/vbr.vbr_train_step``).  No
``DistributedDataParallel``: its reducer expects one backward a step over
every parameter, and the MGDA step takes a backward a level, the dual
step two forwards, and frozen leaves no gradient.

Without a process group every function here acts on the one process:
``process_index`` 0, ``process_count`` 1, the whole batch, the local
values back, and no reduction.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def init_from_env(device=None) -> bool:
    """Join the process group that torchrun's environment describes
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``); returns False, and joins nothing, where
    ``WORLD_SIZE`` is not set.  ``device`` None means CUDA: the backend is
    NCCL and the process takes card ``LOCAL_RANK`` as its current device;
    ``"cpu"`` takes gloo.  A missing CUDA or NCCL raises: the backend is
    never switched quietly."""
    if "WORLD_SIZE" not in os.environ:
        return False
    if dist.is_initialized():
        return True
    dev = torch.device("cuda" if device is None else device)
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "to train over gloo on the CPU")
        if not dist.is_nccl_available():
            raise RuntimeError("this PyTorch has no NCCL: data parallelism "
                               "on CUDA needs it")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device {dev}")
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world)
    return True


def is_distributed() -> bool:
    """Whether this process is in a process group (of any size)."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if is_distributed() else 1


def local_batch_slice(global_batch: int) -> slice:
    """This process's slice of a global batch; the batch must divide
    evenly, so that the mean of the processes' means is the global
    mean."""
    count = process_count()
    if global_batch % count:
        raise ValueError(f"global batch {global_batch} does not divide "
                         f"over {count} processes")
    per = global_batch // count
    return slice(process_index() * per, (process_index() + 1) * per)


def _collective_device() -> torch.device:
    """Where the backend's tensors live: the current card under NCCL, the
    CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def process_allgather(local_values):
    """Every process's ``local_values`` (an array), stacked in process
    order [process_count, ...] on every process, as numpy; on one process
    ``local_values`` back unchanged (``multihost_utils.process_allgather``
    in the JAX package; the reference's ``dist.gather_object``,
    ``compression_trainer.py:854-878``)."""
    if process_count() == 1:
        return local_values
    t = torch.as_tensor(np.asarray(local_values)).to(_collective_device())
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t.contiguous())
    return torch.stack(out).cpu().numpy()


def all_reduce_mean_(tensors) -> None:
    """Replace each tensor by its mean over the processes, in place, by
    one all-reduce of one flat buffer.  The tensors share a dtype and a
    device (the backend's).  Runs whenever there is a process group, of
    one process too (where the mean divides by 1 and changes nothing);
    a no-op without one."""
    tensors = list(tensors)
    if not is_distributed() or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    flat.div_(dist.get_world_size())
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
