from .mesh import (DP_AXIS, FSDP_AXIS, best_mesh_shape, make_eval_mesh, make_mesh,
                   setup_distributed)
from .sharding import fsdp_param_placement, split_rows, wrap_for_training
