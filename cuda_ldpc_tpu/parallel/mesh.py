"""Device meshes and batch sharding for Monte-Carlo data parallelism.

The reference's only parallel axes are 4096 interleaved codewords on one GPU
(bldpc_实习/define.cuh:60) and host std::threads with mutex-shared counters
(myNBLDPC/src/Simulation.cpp:14-48).  Here a 1-D ``batch`` mesh spans every
device: channel tensors carry a leading frame axis sharded over the mesh,
decoders run SPMD under jit, and the per-batch statistics vectors (a few
counters per frame) are the only cross-device reduction.

Multi-host: call ``jax.distributed.initialize()`` before building the mesh and
every process runs the same sweep loop; ``get_mesh`` spans all global devices
and per-host RNG keys are folded with the process index so noise streams never
collide (replacing the reference's mutex-serialized LCG).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def get_mesh(devices=None, axis: str = "batch") -> Mesh:
    devices = list(devices) if devices is not None else jax.devices()
    return Mesh(np.array(devices), (axis,))


def batch_sharding(mesh: Mesh, ndim: int, axis: str = "batch") -> NamedSharding:
    """Shard the leading frame axis, replicate the rest."""
    return NamedSharding(mesh, P(axis, *[None] * (ndim - 1)))


def host_local_batch(total_batch: int, mesh: Mesh) -> int:
    """Frames this process contributes so the global batch is ``total_batch``
    per device * device count."""
    n_local = len([d for d in mesh.devices.flat
                   if d.process_index == jax.process_index()])
    return total_batch * n_local
