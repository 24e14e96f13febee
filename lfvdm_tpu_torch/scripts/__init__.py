"""The port's command-line entry points (counterparts of the repo's
``scripts/video_sample.py`` and ``scripts/video_train.py``):

    python -m lfvdm_tpu_torch.scripts.video_sample CHECKPOINT --sampling_scheme ...
    python -m lfvdm_tpu_torch.scripts.video_train --dataset ...

Each has its JAX counterpart's flags and defaults, plus ``--device`` (default
``cuda``); ``main(argv)`` runs it in process.
"""
