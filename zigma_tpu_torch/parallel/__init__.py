"""Parallelism for the port (M10 without the pipeline): process groups and
the ``("data", "model")`` mesh, DDP, FSDP2 and tensor parallelism
(``mesh.py``), their autograd-aware collectives (``collectives.py``) and
the sequence-parallel scans (``seq_parallel.py``).  Counterpart of
``zigma_tpu/parallel``; the pipeline (``pipeline.py`` there) is the next
slice of the port."""

from zigma_tpu_torch.parallel.mesh import (ParallelLayout, apply_tensor_parallel,
                                           init_process_group, make_mesh,
                                           parallelize, replicate,
                                           shard_batch, tp_rules, tp_shard,
                                           tp_unshard)
from zigma_tpu_torch.parallel.seq_parallel import (prefix_states,
                                                   selective_scan_seq_parallel,
                                                   selective_scan_sharded,
                                                   ssd_scan_sharded,
                                                   ssd_seq_parallel)

__all__ = ["init_process_group", "make_mesh", "shard_batch", "replicate",
           "tp_rules", "tp_shard", "tp_unshard", "apply_tensor_parallel",
           "ParallelLayout", "parallelize", "prefix_states",
           "selective_scan_seq_parallel", "selective_scan_sharded",
           "ssd_seq_parallel", "ssd_scan_sharded"]
