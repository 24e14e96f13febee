"""The port's command-line entry points (counterparts of the repo's
``scripts/video_sample.py``, ``scripts/video_train.py`` and
``scripts/video_optimal_schedule.py``):

    python -m lfvdm_tpu_torch.scripts.video_sample CHECKPOINT --sampling_scheme ...
    python -m lfvdm_tpu_torch.scripts.video_train --dataset ...
    python -m lfvdm_tpu_torch.scripts.video_optimal_schedule --eval_dir DIR ...

Each has its JAX counterpart's flags and defaults, plus ``--device`` (default
``cuda``); ``main(argv)`` runs it in process.
"""
