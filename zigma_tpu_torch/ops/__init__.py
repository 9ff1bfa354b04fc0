from zigma_tpu_torch.ops.paths import (
    build_layer_paths,
    hilbert_path,
    parallel_scan_perms,
    random_paths,
    reverse_permutation,
    video_time_paths,
    zigzag_path,
)
from zigma_tpu_torch.ops.norms import add_norm, layer_norm, rms_norm
from zigma_tpu_torch.ops.causal_conv1d import (causal_conv1d,
                                               causal_conv1d_bwd_ref,
                                               causal_conv1d_ref,
                                               causal_conv1d_update)
from zigma_tpu_torch.ops.selective_scan import (scan_backend, scan_with_grad,
                                                selective_scan,
                                                selective_scan_bwd_ref,
                                                selective_scan_flops,
                                                selective_scan_ref,
                                                selective_state_update)
from zigma_tpu_torch.ops.scan_chunked import (selective_scan_assoc,
                                              selective_scan_chunked)
from zigma_tpu_torch.ops.scan_cuda import (cuda_shape_supported,
                                           selective_scan_bwd_cuda,
                                           selective_scan_fwd_cuda)
from zigma_tpu_torch.ops.ssd import ssd_scan, ssd_scan_ref, ssd_state_update

__all__ = [
    "build_layer_paths",
    "hilbert_path",
    "parallel_scan_perms",
    "random_paths",
    "reverse_permutation",
    "video_time_paths",
    "zigzag_path",
    "add_norm",
    "layer_norm",
    "rms_norm",
    "causal_conv1d",
    "causal_conv1d_update",
    "causal_conv1d_ref",
    "causal_conv1d_bwd_ref",
    "scan_backend",
    "scan_with_grad",
    "selective_scan",
    "selective_scan_assoc",
    "selective_scan_chunked",
    "selective_scan_flops",
    "cuda_shape_supported",
    "selective_scan_ref",
    "selective_state_update",
    "selective_scan_bwd_ref",
    "selective_scan_fwd_cuda",
    "selective_scan_bwd_cuda",
    "ssd_scan",
    "ssd_scan_ref",
    "ssd_state_update",
]
