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
                and the torch.ops.lfvdm operators
  diffusion/  — schedules, Gaussian diffusion (ancestral, DDIM, training
                losses), DPM-Solver++, timestep samplers, the codecs of
                the diffusion spaces and the wavelet transform
  sampling/   — long-video sampling schemes and the sampler driver
  training/   — masks, the train step and loop, checkpoints, vis sampling
  data/       — the dataset registry (CARLA, MineRL, GQN-mazes, synthetic,
                pre-encoded latents), the prefetching loader, the binding
                of the native loader
  native/     — the native C++ video loader's source (built with g++)
  serving.py  — the window sampler exported with torch.export, served from
                an artifact and a params .npz without the model code
  scripts/    — the entry points: video_sample, video_train, the evals',
                export_sampler, export_params
  utils/      — reference .pt loading, JAX-tree <-> state_dict / train-state
                / VAE conversion, flax's msgpack files, device selection,
                the metrics logger, results paths, RNG scoping, video
                files, a file lock
"""

__version__ = "0.1.0"
