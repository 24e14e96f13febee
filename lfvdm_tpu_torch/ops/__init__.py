"""Hand-written CUDA kernels for Hopper (sm_90a), with their plain versions."""

from .adamw import fused_adamw_ema, fused_adamw_ema_plain  # noqa: F401
from .attention import (  # noqa: F401
    launch_counts,
    reset_launch_counts,
    spatial_attention,
    spatial_attention_plain,
    temporal_rpe_attention,
    temporal_rpe_attention_plain,
)
from .groupnorm import group_norm_silu, group_norm_silu_plain  # noqa: F401
from .skipconv import skip_conv_stats, skip_conv_stats_plain  # noqa: F401
