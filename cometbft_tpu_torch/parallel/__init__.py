"""Verification over several fault domains (parallel/mesh.py): the port of
cometbft_tpu/parallel/__init__.py.

- `sharded_verify_batch`: the SPMD plane, one batch staged once and the
  verify kernel launched once a domain on its lane slice; fastest for one
  healthy batch over healthy domains, and failed by a fault in any.
- `VerifyMesh`: the fault-tolerant plane the VerifyScheduler routes
  through: a DeviceSupervisor and CircuitBreaker a domain, class-aware
  placement, eviction and readmission with in-flight shards dispatched
  again over the survivors, and the single-card path when every domain is
  dead.

A domain is a device and an index (its own stream and key tables), so one
card can hold several and the CPU tests run them on the CPU.
"""

from cometbft_tpu_torch.parallel.mesh import (  # noqa: F401
    VerifyMesh,
    batch_mesh,
    shard_verify_kernel,
    sharded_verify_batch,
)
