"""Multi-host corpus runs (port of vbx_tpu.parallel.distributed).

A corpus run on N hosts is N identical processes that call `initialize()`
and then shard the recordings over the processes: each owns a contiguous
slice (`local_recording_slice`), writes its per-recording outputs to shared
storage, and waits at one barrier a stage before host 0 concatenates them.
Recordings are independent, so nothing moves between processes except
files and those barriers: the reference's process model (one task line per
recording fanned out to a grid engine, AMI_run.sh:30-33,53-58), minus the
grid engine.

vbx_tpu forms a jax.distributed cluster; the port forms a torch.distributed
process group on the gloo backend. Gloo, not NCCL: no tensor crosses
processes, and NCCL will not put two ranks on one card, which a one-card
machine running two processes needs.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch.distributed as dist

# How long a collective may wait. A stage's barrier waits for the slowest
# host's whole stage (hours on a large corpus), so a short timeout would end
# healthy runs. A peer that dies closes its connections, and the waiting
# hosts' barrier raises at once; the timeout only ends a peer that hangs.
TIMEOUT = datetime.timedelta(hours=48)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the corpus run's process group, with the environment as
    fallback (COORDINATOR_ADDRESS as host:port, NUM_PROCESSES, PROCESS_ID);
    a no-op in a single process with no configuration.

    Process 0 serves the group's rendezvous at the coordinator address.
    A configuration that cannot form a group (a count or a rank without a
    coordinator, a coordinator without a count or a rank, a rank out of
    range) raises ValueError: the process never carries on alone."""
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS")
    if num_processes is None and "NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["NUM_PROCESSES"])
    if process_id is None and "PROCESS_ID" in os.environ:
        process_id = int(os.environ["PROCESS_ID"])
    if coordinator_address is None and num_processes is None \
            and process_id is None:
        return                          # single-process run
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            f"a multi-process run needs a coordinator address, a process "
            f"count and a process id (COORDINATOR_ADDRESS, NUM_PROCESSES, "
            f"PROCESS_ID); got {coordinator_address!r}, {num_processes!r}, "
            f"{process_id!r}")
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is out of range for "
                         f"{num_processes} process(es)")
    dist.init_process_group("gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)


def process_index() -> int:
    """This process's index in the run (jax.process_index's counterpart):
    0 without a group."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes in the run (jax.process_count's
    counterpart): 1 without a group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_recording_slice(n_recordings: int) -> slice:
    """The contiguous slice of a recording list owned by this process
    (corpus sharding over hosts)."""
    p = process_index()
    n = process_count()
    per = -(-n_recordings // n)
    return slice(p * per, min((p + 1) * per, n_recordings))


def barrier(name: str) -> None:
    """Wait until every process of the run has arrived here
    (multihost_utils.sync_global_devices' counterpart); a no-op in a
    single process. A peer that died, or did not arrive within TIMEOUT,
    raises RuntimeError naming the barrier."""
    if process_count() == 1:
        return
    try:
        dist.barrier()
    except RuntimeError as exc:
        raise RuntimeError(f"barrier {name!r} failed: a process of the run "
                           f"died or did not arrive ({exc})") from exc
