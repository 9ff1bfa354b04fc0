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
from zigma_tpu_torch.ops.causal_conv1d import causal_conv1d
from zigma_tpu_torch.ops.selective_scan import (SelectiveScanFn, selective_scan,
                                                selective_scan_bwd_ref,
                                                selective_scan_ref)
from zigma_tpu_torch.ops.scan_cuda import (selective_scan_bwd_cuda,
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
    "SelectiveScanFn",
    "selective_scan",
    "selective_scan_ref",
    "selective_scan_bwd_ref",
    "selective_scan_fwd_cuda",
    "selective_scan_bwd_cuda",
    "ssd_scan",
    "ssd_scan_ref",
    "ssd_state_update",
]
