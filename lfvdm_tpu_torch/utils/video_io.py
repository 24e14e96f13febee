"""Video export helpers: observed-frame marking, gif/avi/mp4 writing (a
copy of lfvdm_tpu/utils/video_io.py, the reference's test_util helpers).

PIL, imageio and cv2 are imported inside the functions that use them.
"""

from __future__ import annotations

import subprocess
from pathlib import Path

import numpy as np


def mark_as_observed(images: np.ndarray, color=(255, 0, 0)):
    """Draw a border of ``color`` in-place on (..., C, H, W) uint8 frames.

    Non-RGB channel counts (latent-space or synthetic debug videos) get the
    border on the channels that exist instead of crashing like the
    reference's RGB-only version (test_util.py:76-81).
    """
    C = images.shape[-3]
    for i, c in enumerate(color[:C]):
        images[..., i, :, 1:2] = c
        images[..., i, 1:2, :] = c
        images[..., i, :, -2:-1] = c
        images[..., i, -2:-1, :] = c


def tensor2avi(tensor: np.ndarray, path, drange=(0, 255)):
    frames = _to_uint8_thwc(tensor, drange)
    try:
        import imageio

        imageio.mimwrite(str(path), frames, fps=10)
    except (ImportError, ValueError):
        _cv2_write(frames, path, fourcc="MJPG")


def _as_rgb(frames_thwc: np.ndarray) -> np.ndarray:
    """(T, H, W, C) uint8 for any C -> 3-channel RGB view for encoders:
    grayscale repeats, 2-channel (debug/synthetic) pads a zero blue channel,
    >3 (latent-space saves) keeps the first three."""
    C = frames_thwc.shape[-1]
    if C == 1:
        return np.repeat(frames_thwc, 3, axis=-1)
    if C == 2:
        zero = np.zeros_like(frames_thwc[..., :1])
        return np.concatenate([frames_thwc, zero], axis=-1)
    return frames_thwc[..., :3]


def tensor2gif(tensor: np.ndarray, path, drange=(0, 255), random_str=""):
    from PIL import Image

    frames = [Image.fromarray(f) for f in _as_rgb(_to_uint8_thwc(tensor, drange))]
    frames[0].save(str(path), save_all=True, append_images=frames[1:],
                   duration=100, loop=0)


def tensor2mp4(tensor: np.ndarray, path, drange=(0, 255), random_str="tmp"):
    """Write an mp4 via ffmpeg (gif intermediate, test_util.py:99-111);
    falls back to imageio when ffmpeg is unavailable."""
    gif_path = Path(str(path)).with_suffix(f".{random_str}.gif")
    tensor2gif(tensor, gif_path, drange=drange)
    try:
        subprocess.run(
            ["ffmpeg", "-y", "-i", str(gif_path),
             "-r", "10", "-movflags", "faststart", "-pix_fmt", "yuv420p",
             "-vf", "scale=trunc(iw/2)*2:trunc(ih/2)*2", str(path)],
            check=True, capture_output=True,
        )
    except (FileNotFoundError, subprocess.CalledProcessError):
        try:
            import imageio

            imageio.mimwrite(str(path), _to_uint8_thwc(tensor, drange), fps=10)
        except (ImportError, ValueError):
            # no ffmpeg CLI and no imageio ffmpeg plugin: OpenCV ships its
            # own encoder, so mp4 export still works in hermetic envs
            _cv2_write(_to_uint8_thwc(tensor, drange), path, fourcc="mp4v")
    finally:
        gif_path.unlink(missing_ok=True)


def _cv2_write(frames_thwc: np.ndarray, path, fourcc: str, fps: int = 10):
    import cv2

    frames_thwc = _as_rgb(frames_thwc)
    T, H, W, _ = frames_thwc.shape
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc),
                             fps, (W, H))
    if not writer.isOpened():
        raise RuntimeError(f"cv2.VideoWriter could not open {path}")
    try:
        for f in frames_thwc:
            writer.write(f[:, :, ::-1])  # RGB -> BGR
    finally:
        writer.release()


def _to_uint8_thwc(tensor: np.ndarray, drange) -> np.ndarray:
    """(T, C, H, W) any-range -> (T, H, W, C) uint8."""
    t = np.asarray(tensor, np.float32)
    lo, hi = drange
    t = (t - lo) / (hi - lo) * 255.0
    return t.clip(0, 255).astype(np.uint8).transpose(0, 2, 3, 1)
