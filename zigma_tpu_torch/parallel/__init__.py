"""Parallelism for the port (M10): process groups and the ``("data",
"model"[, "pipe"])`` mesh, DDP, FSDP2 and tensor parallelism (``mesh.py``),
their autograd-aware collectives (``collectives.py``), the
sequence-parallel scans (``seq_parallel.py``) and the GPipe pipeline over
the block stack (``pipeline.py``).  Counterpart of ``zigma_tpu/parallel``."""

from zigma_tpu_torch.parallel.mesh import (ParallelLayout, apply_tensor_parallel,
                                           data_rank, init_process_group,
                                           make_mesh, parallelize, replicate,
                                           same_in_group, shard_batch,
                                           tp_rules, tp_shard, tp_unshard)
from zigma_tpu_torch.parallel.pipeline import (PipelinedZigMa, PipelineLayout,
                                               pipeline_blocks,
                                               pipeline_parallelize,
                                               split_stage,
                                               zigma_pipelined_apply)
from zigma_tpu_torch.parallel.seq_parallel import (prefix_states,
                                                   selective_scan_seq_parallel,
                                                   selective_scan_sharded,
                                                   ssd_scan_sharded,
                                                   ssd_seq_parallel)

__all__ = ["init_process_group", "make_mesh", "data_rank", "shard_batch",
           "same_in_group", "replicate", "tp_rules", "tp_shard", "tp_unshard",
           "apply_tensor_parallel", "ParallelLayout", "parallelize",
           "split_stage", "pipeline_blocks", "zigma_pipelined_apply",
           "PipelinedZigMa", "PipelineLayout", "pipeline_parallelize",
           "prefix_states", "selective_scan_seq_parallel",
           "selective_scan_sharded", "ssd_seq_parallel", "ssd_scan_sharded"]
