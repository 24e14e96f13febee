"""The sampling schemes that plan a long video window by window, as
Flexible Diffusion Models defines them (the reference code's
improved_diffusion/sampling_schemes.py): a frozen copy of the port's
``sampling/schemes.py``, the two schemes the cells run (autoregressive
and two-level hierarchy), which the benchmark runs against the windows the
program sampled. Each is an iterator of
``(observed frame indices, latent frame indices)`` per window."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class SamplingSchemeBase:
    """Tracks generated frames and plans each model call.

    Args:
      video_length: total frames to generate.
      num_obs: frames observed (given) at the start of the video.
      max_frames: max frames (obs + latent) per model call (K).
      step_size: latent frames generated per call.
    """

    def __init__(self, video_length: int, num_obs: int, max_frames: int, step_size: int):
        self._video_length = video_length
        self._max_frames = max_frames
        self._num_obs = num_obs
        self._done_frames = set(range(num_obs))
        self._obs_frames = list(range(num_obs))
        self._step_size = step_size
        self._current_step = 0
        self.B: Optional[int] = None

    def get_unconditional_indices(self) -> List[int]:
        return list(range(self._max_frames))

    def next_indices(self) -> Tuple[List[int], List[int]]:
        raise NotImplementedError

    def is_done(self) -> bool:
        return len(self._done_frames) >= self._video_length

    def set_videos(self, videos):
        """Record batch size; adaptive schemes also keep the samples."""
        self.B = len(videos)

    def __iter__(self):
        return self

    def __next__(self):
        if self.is_done():
            raise StopIteration
        unconditional = False
        if self._num_obs == 0 and self._current_step == 0:
            obs_frame_indices: List[int] = []
            latent_frame_indices = self.get_unconditional_indices()
            unconditional = True
        else:
            obs_frame_indices, latent_frame_indices = self.next_indices()
        assert isinstance(obs_frame_indices, list) and isinstance(latent_frame_indices, list)
        for idx in obs_frame_indices:
            assert idx in self._done_frames, (
                f"Attempting to condition on frame {idx} before it is generated.\n"
                f"Generated: {sorted(self._done_frames)}\nObserving: {obs_frame_indices}\n"
                f"Generating: {latent_frame_indices}"
            )
        assert all(i < self._video_length for i in latent_frame_indices)
        self._done_frames.update(latent_frame_indices)
        if unconditional:
            self._obs_frames = latent_frame_indices
        self._current_step += 1
        if self.B is not None:
            return [obs_frame_indices] * self.B, [latent_frame_indices] * self.B
        return obs_frame_indices, latent_frame_indices

    @property
    def typename(self):
        return type(self).__name__


class Autoregressive(SamplingSchemeBase):
    """Condition on the most recent frames, generate the next step_size."""

    def next_indices(self):
        if not self._done_frames:
            return [], list(range(self._max_frames))
        obs = sorted(self._done_frames)[-(self._max_frames - self._step_size):]
        first = obs[-1] + 1
        latent = list(range(first, min(first + self._step_size, self._video_length)))
        return obs, latent


class HierarchyNLevel(SamplingSchemeBase):
    """N-level coarse-to-fine: a sparse grid first, then infill passes."""

    N: int = 2  # overridden by make_hierarchy()

    def get_unconditional_indices(self):
        self.current_level = 1
        self.last_sampled_idx = self._video_length - 1
        return [int(i) for i in np.linspace(0, self._video_length - 1, self._max_frames)]

    @property
    def sample_every(self) -> int:
        level1 = (self._video_length - len(self._obs_frames)) / (self._step_size - 1)
        return int(level1 ** ((self.N - self.current_level) / (self.N - 1)))

    def _grid_latents(self, n_to_sample: int) -> List[int]:
        """Pick the next stride-spaced group of not-yet-generated frames."""
        idx = self.last_sampled_idx + self.sample_every
        if not any(i not in self._done_frames for i in range(idx, self._video_length)):
            # nothing left after idx: move to the next (finer) level
            self.current_level += 1
            self.last_sampled_idx = 0
            first_missing = min(i for i in range(self._video_length) if i not in self._done_frames)
            idx = first_missing - 1 + self.sample_every
        if self.current_level == 1:
            return [int(i) for i in np.linspace(
                max(self._obs_frames) + 1, self._video_length - 0.001, n_to_sample)]
        latent: List[int] = []
        while len(latent) < n_to_sample and idx < self._video_length:
            if idx not in self._done_frames:
                latent.append(idx)
                idx += self.sample_every
            else:
                idx += 1
        return latent

    def next_indices(self):
        if not self._done_frames:
            self.current_level = 1
            self.last_sampled_idx = self._video_length - 1
            return [], [int(i) for i in np.linspace(0, self._video_length - 1, self._max_frames)]
        if len(self._done_frames) == len(self._obs_frames):
            self.current_level = 1
            self.last_sampled_idx = max(self._obs_frames)

        n_cond = self._max_frames - self._step_size
        latent = self._grid_latents(self._step_size)

        # condition on every done frame lying between the latents
        obs = [i for i in range(min(latent), max(latent)) if i in self._done_frames]
        remaining = n_cond - len(obs)
        if remaining < 2:
            # shrink step_size so we can bracket the latents on both sides
            if self._step_size == 1:
                raise RuntimeError("cannot condition before and after even with step size 1")
            self._step_size -= 1
            try:
                return self.next_indices()
            finally:
                self._step_size += 1

        max_after = remaining // 2
        obs.extend([i for i in range(max(latent) + 1, self._video_length)
                    if i in self._done_frames][:max_after])
        n_before = n_cond - len(obs)
        if self.current_level == 1:
            obs.extend(list(np.linspace(0, max(self._obs_frames) + 0.999, n_before).astype(np.int32)))
        else:
            obs.extend([i for i in range(min(latent) - 1, -1, -1)
                        if i in self._done_frames][:n_before])

        self.last_sampled_idx = max(latent)
        return obs, latent


def make_hierarchy(n: int):
    class _Hierarchy(HierarchyNLevel):
        N = n

    return _Hierarchy


sampling_schemes = {
    "autoreg": Autoregressive,
    "hierarchy-2": make_hierarchy(2),
}
