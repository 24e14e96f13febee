from .unet import UNetVideoModel  # noqa: F401
from .nn import timestep_embedding, GroupNorm32  # noqa: F401
