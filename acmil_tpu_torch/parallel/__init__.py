"""Step3 across processes: the ``(data, seq)`` mesh as ``torch.distributed``
process groups (:mod:`.mesh`) and the collectives its sharded ops use
(:mod:`.collectives`), the port of ``acmil_tpu/parallel``."""

from acmil_tpu_torch.parallel.mesh import (Mesh, active, current,
                                           gather_seq, init_distributed,
                                           local_device, make_mesh,
                                           make_pod_mesh, shard_bag,
                                           shard_params)

__all__ = ["Mesh", "active", "current", "gather_seq", "init_distributed",
           "local_device", "make_mesh", "make_pod_mesh", "shard_bag",
           "shard_params"]
