"""Hand-written CUDA kernels for Hopper (sm_90a), with their plain versions."""

from .attention import (  # noqa: F401
    launch_counts,
    reset_launch_counts,
    spatial_attention,
    spatial_attention_plain,
    temporal_rpe_attention,
    temporal_rpe_attention_plain,
)
from .skipconv import skip_conv_stats, skip_conv_stats_plain  # noqa: F401
