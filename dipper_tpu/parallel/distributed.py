"""Multi-host (multi-process) distribution.

The reference is a single-process, single-GPU binary (SURVEY §2.4:
"Communication backend: none"). This layer is the multi-host scale-out
path: `jax.distributed` joins N processes (one per host) into one
runtime whose devices form a single global mesh; the sharded engines
(parallel/sharded.py, nj/engine.py mesh path, dc pipeline mesh path)
run unchanged on that mesh — their psum/all_gather collectives go
through NCCL, over NVLink within a host and the network across hosts,
inserted by GSPMD exactly as in the single-process multi-GPU case.
jax.distributed.initialize needs its coordinator address, process count
and process id: nothing on a plain machine tells JAX of a cluster.

Entry points:
- init_distributed(): jax.distributed.initialize with env-var
  fallbacks (DIPPER_COORDINATOR / DIPPER_NUM_PROCESSES /
  DIPPER_PROCESS_ID, or the standard JAX_* cluster envs).
- global_mesh(): 1-D mesh over every device of every process.
- to_host(x): device_get that also works for globally-sharded arrays
  (process_allgather under the hood) — host-side finalization (Newick
  assembly) happens on process 0.

Tested by tests/test_multihost.py: two localhost CPU processes (gloo
collectives, 4 virtual devices each) run the same
psum/all_gather/axis_index collectives the sharded placement build
uses, plus a cross-process sharded NJ matching the single-process
tree.
"""

from __future__ import annotations

import os

import numpy as np


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_count: int | None = None):
    """Join (or start) a multi-process JAX runtime. No-op when neither
    arguments nor DIPPER_* / auto-detectable cluster envs are present.
    Returns (process_id, num_processes)."""
    import jax

    coordinator = coordinator or os.environ.get("DIPPER_COORDINATOR")
    if num_processes is None and os.environ.get("DIPPER_NUM_PROCESSES"):
        num_processes = int(os.environ["DIPPER_NUM_PROCESSES"])
    if process_id is None and os.environ.get("DIPPER_PROCESS_ID"):
        process_id = int(os.environ["DIPPER_PROCESS_ID"])
    if coordinator is None and num_processes is None:
        return 0, 1
    kw = dict(coordinator_address=coordinator,
              num_processes=num_processes, process_id=process_id)
    if local_device_count is not None:
        kw["local_device_ids"] = list(range(local_device_count))
    jax.distributed.initialize(**kw)
    return jax.process_index(), jax.process_count()


def global_mesh(axis: str = "d"):
    """1-D mesh over all devices of all processes (process-major order,
    which keeps each process's shard rows contiguous)."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), (axis,))


def to_host(x):
    """device_get that tolerates globally-sharded (non-addressable)
    arrays by all-gathering across processes first."""
    import jax

    def one(a):
        if getattr(a, "is_fully_addressable", True):
            return jax.device_get(a)
        from jax.experimental import multihost_utils

        return multihost_utils.process_allgather(a, tiled=True)

    return jax.tree_util.tree_map(one, x)


def is_primary() -> bool:
    import jax

    return jax.process_index() == 0
