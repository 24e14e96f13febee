"""lfvdm_tpu_torch — the PyTorch/CUDA port of lfvdm_tpu.

The same module layout as the JAX package, each module the counterpart of
its namesake there. It imports torch and numpy only (never JAX or
lfvdm_tpu). Entry points run on the card (``device="cuda"``) unless the
caller asks for the CPU; on the card the U-Net's attention runs the
hand-written CUDA kernels of ``ops/``.

Package layout:
  config.py   — defaults dict, flagship config, model + diffusion factory
  models/     — video U-Net, RPE attention, NN primitives
  ops/        — CUDA kernels (csrc/), their build, plain versions, wrappers
  diffusion/  — schedules, Gaussian diffusion (ancestral, DDIM), DPM-Solver++
  sampling/   — long-video sampling schemes and the sampler driver
  utils/      — JAX-tree -> state_dict conversion, device selection
"""

__version__ = "0.1.0"
