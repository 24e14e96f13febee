"""lfvdm_tpu_torch — the PyTorch/CUDA port of lfvdm_tpu.

The same module layout as the JAX package, each module the counterpart of
its namesake there. It imports torch and numpy only (never JAX or
lfvdm_tpu). Entry points run on the card (``device="cuda"``) unless the
caller asks for the CPU; on the card the U-Net's attention and up-path skip
projections run the hand-written CUDA kernels of ``ops/``. Diffusion runs in
pixel, SVD-VAE latent or Haar wavelet space (``diffusion/codecs.py``).

Package layout:
  config.py   — defaults dict, flagship and latent configs, model +
                diffusion factory
  models/     — video U-Net, RPE attention, NN primitives, the SVD VAE
  ops/        — CUDA kernels (csrc/), their build, plain versions, wrappers
  diffusion/  — schedules, Gaussian diffusion (ancestral, DDIM, training
                losses), DPM-Solver++, timestep samplers, the codecs of
                the diffusion spaces and the wavelet transform
  sampling/   — long-video sampling schemes and the sampler driver
  training/   — masks, the train step and loop, checkpoints
  data/       — synthetic video datasets, pre-encoded latent datasets
  utils/      — JAX-tree -> state_dict / train-state / VAE conversion,
                device selection, the metrics logger, a file lock
"""

__version__ = "0.1.0"
