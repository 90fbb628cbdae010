"""Joining a multi-process filter array: ``torch.distributed``.

The port of ``tpubloom/parallel/distributed.py``. On a TPU pod the
collective layer is XLA over ICI/DCN and ``jax.distributed.initialize``
joins the hosts. Here the processes join a ``torch.distributed`` process
group, one rank a process:

* **within a process**: the slots of a
  :class:`~tpubloom_torch.parallel.sharded.ShardedBloomFilter` answer for
  their own shards and their verdicts meet on the first slot's device
  (a peer copy between cards, which is what ``psum`` over ICI is);
* **across processes**: once a group is joined, each rank holds only its
  share of the shards (:func:`~tpubloom_torch.parallel.sharded.rank_shards`)
  and the verdicts combine with one ``all_reduce`` over the group;
* **host <-> client**: the gRPC server (:mod:`tpubloom_torch.server`).

The backend is ``nccl`` when the caller's devices are CUDA cards and
``gloo`` otherwise; ``backend=`` picks one explicitly (two ranks sharing
one card need ``gloo``: NCCL refuses two ranks on one GPU). There is no
fallback: a join that fails raises.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from tpubloom_torch import faults

log = logging.getLogger("tpubloom_torch.distributed")

#: how long a join, and every collective of the group after it, may wait
#: for the other ranks before it raises
DEFAULT_TIMEOUT_S = 300.0


def _local_rank(process_id: int) -> int:
    """The card this rank drives: torchrun's ``LOCAL_RANK`` where set,
    else the rank modulo the cards of this host."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return process_id % max(1, torch.cuda.device_count())


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    auto_detect: bool = False,
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> dict:
    """Join (or bootstrap) a multi-process filter array.

    Three modes, as in ``tpubloom``:

    * explicit: ``coordinator_address`` (``host:port`` of rank 0's
      rendezvous), ``num_processes`` > 1 and ``process_id`` join through
      ``tcp://<coordinator_address>``;
    * ``auto_detect=True``: join through ``env://``, which reads torchrun's
      ``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE`` (in
      place of the TPU pod metadata);
    * neither (default): a single-process no-op returning the local
      topology, safe to call unconditionally.

    ``backend`` defaults to ``nccl`` where CUDA is available, else
    ``gloo``; with ``nccl`` each rank first selects its card
    (``LOCAL_RANK``, else the rank modulo the host's cards). Returns
    ``{process_index, process_count, local_device_count,
    global_device_count}``, counting CUDA cards."""
    # a bring-up that dies at the coordinator join is its own failure
    # class, before any join is attempted
    faults.fire("dist.initialize")
    if num_processes is not None and num_processes > 1:
        if coordinator_address is None or process_id is None:
            raise ValueError(
                "a multi-process join needs coordinator_address and process_id"
            )
        backend = _join(
            backend, f"tcp://{coordinator_address}", timeout_s,
            world_size=num_processes, rank=process_id,
        )
        log.info(
            "joined a %s group: process %s/%s, coordinator %s",
            backend, process_id, num_processes, coordinator_address,
        )
    elif auto_detect:
        backend = _join(backend, "env://", timeout_s)
        log.info("joined a %s group through env://", backend)
    topo = topology()
    log.info("topology: %s", topo)
    return topo


def _join(backend: Optional[str], init_method: str, timeout_s: float, **kw) -> str:
    if dist.is_initialized():
        raise RuntimeError("a torch.distributed process group is already joined")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        rank = kw.get("rank", int(os.environ.get("RANK", "0")))
        torch.cuda.set_device(_local_rank(rank))
    dist.init_process_group(
        backend=backend, init_method=init_method,
        timeout=datetime.timedelta(seconds=timeout_s), **kw,
    )
    return backend


def topology() -> dict:
    """The reference's four keys for this process. Once a group is joined,
    ``global_device_count`` sums the ranks' cards with one ``all_reduce``,
    so every rank must call this too."""
    local = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not dist.is_initialized():
        return {
            "process_index": 0, "process_count": 1,
            "local_device_count": local, "global_device_count": local,
        }
    on = torch.device("cuda") if dist.get_backend() == "nccl" else torch.device("cpu")
    total = torch.tensor([local], dtype=torch.int64, device=on)
    dist.all_reduce(total)
    return {
        "process_index": dist.get_rank(), "process_count": dist.get_world_size(),
        "local_device_count": local, "global_device_count": int(total.item()),
    }


def shutdown() -> None:
    """Leave the process group (``jax.distributed.shutdown``'s
    counterpart); a no-op when none is joined."""
    if dist.is_initialized():
        dist.destroy_process_group()
