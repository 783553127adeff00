"""Step3 and Step2 across processes, the port of ``acmil_tpu/parallel``:
the ``(data, seq, model)`` mesh as ``torch.distributed`` process groups
(:mod:`.mesh`), the collectives its sharded ops use (:mod:`.collectives`),
and the tensor parallelism of Step2's ViT trunks (:mod:`.tp`, imported at
use)."""

from acmil_tpu_torch.parallel.mesh import (Mesh, active, current,
                                           gather_seq, init_distributed,
                                           local_device, make_mesh,
                                           make_pod_mesh, shard_bag,
                                           shard_params)

__all__ = ["Mesh", "active", "current", "gather_seq", "init_distributed",
           "local_device", "make_mesh", "make_pod_mesh", "shard_bag",
           "shard_params"]
