"""Flexible long-video sampling schemes (host-side index planners).

A copy of lfvdm_tpu/sampling/schemes.py, kept so that the port imports
without JAX. The adaptive schemes default to the port's own LPIPS embedder
(``evals/lpips.py``) on the device they are given.

Capability parity: the reference implementation's improved_diffusion/sampling_schemes.py.

Each scheme is a stateful iterator yielding
``(obs_frame_indices, latent_frame_indices)`` per model call: which already-
generated frames to condition on and which to generate next. The network
only ever sees max_frames ≤ 20 frames — long videos (T up to 1000) are
covered by these schedules, not by sequence parallelism (SURVEY.md §5).

The planners are pure Python/numpy; the sampler driver
(sampling/driver.py) turns their output into per-window gathers.
Adaptive schemes additionally score candidate conditioning frames with a
perceptual embedder (LPIPS); the embedder is injected as a callable so the
planner logic stays device-agnostic and testable.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np


class SamplingSchemeBase:
    """Tracks generated frames and plans each model call.

    Args:
      video_length: total frames to generate.
      num_obs: frames observed (given) at the start of the video.
      max_frames: max frames (obs + latent) per model call (K).
      step_size: latent frames generated per call.
      optimal_schedule: optional dict step -> list of obs indices that
        overrides each step's conditioning (the reference loads this from a
        .pt file, sampling_schemes.py:62; here any mapping works).
    """

    def __init__(self, video_length: int, num_obs: int, max_frames: int,
                 step_size: int, optimal_schedule: Optional[dict] = None):
        self._video_length = video_length
        self._max_frames = max_frames
        self._num_obs = num_obs
        self._done_frames = set(range(num_obs))
        self._obs_frames = list(range(num_obs))
        self._step_size = step_size
        self.optimal_schedule = optimal_schedule
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
            if self.optimal_schedule is not None:
                if self._current_step not in self.optimal_schedule:
                    print(f"WARNING: no optimal observations for step #{self._current_step}.")
                    obs_frame_indices = []
                else:
                    obs_frame_indices = list(self.optimal_schedule[self._current_step])
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


class LongRangeAutoregressive(SamplingSchemeBase):
    """Half the conditioning budget on recent frames, rest on the originals."""

    def next_indices(self):
        n_cond = self._max_frames - self._step_size
        n_autoreg = n_cond // 2
        chosen = set(sorted(self._done_frames)[-n_autoreg:])
        for i in sorted(self._obs_frames, reverse=True):
            chosen.add(i)
            if len(chosen) == n_cond:
                break
        obs = sorted(chosen)
        first = max(self._done_frames) + 1
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

    @property
    def typename(self):
        return f"{super().typename}-{self.N}"


# ---- adaptive (perceptual-distance-driven) schemes ----

Embedder = Callable[[np.ndarray], np.ndarray]  # (B, C, H, W) -> (B, E)


class AdaptiveSamplingSchemeBase(SamplingSchemeBase):
    """Greedy max-min perceptual-distance selection of conditioning frames.

    ``embedder`` maps a batch of frames to embeddings whose squared L2
    distance equals the perceptual (LPIPS) distance; by default the
    process's ``evals.lpips.default_lpips_embedder`` on ``device`` (the card
    unless the caller names another). Per batch element the conditioning set
    differs, so __next__ yields per-element index lists.
    """

    def __init__(self, *args, embedder: Optional[Embedder] = None, device="cuda", **kwargs):
        super().__init__(*args, **kwargs)
        if embedder is None:
            from ..evals.lpips import default_lpips_embedder

            embedder = default_lpips_embedder(device)
        self._embedder = embedder
        self.videos: Optional[np.ndarray] = None

    def set_videos(self, videos):
        self.videos = np.asarray(videos)
        self.B = len(self.videos)
        self._emb_cache = None  # new buffer contents -> re-embed lazily

    def embed(self, indices) -> np.ndarray:
        # Embed the WHOLE sample buffer once per set_videos (one fixed-shape
        # device call) and slice per request, rather than one device round
        # trip per candidate frame. Embeddings are identical;
        # not-yet-generated frames embed too but are never selected (the
        # consumer only scores done frames).
        if getattr(self, "_emb_cache", None) is None:
            B, T = self.videos.shape[:2]
            flat = self.videos.reshape(B * T, *self.videos.shape[2:])
            self._emb_cache = np.asarray(self._embedder(flat)).reshape(B, T, -1)
        return self._emb_cache[:, np.asarray(indices)]

    def select_obs_indices(self, possible_next_indices, n, always_selected=(0,)):
        B = len(self.videos)
        embs = self.embed(possible_next_indices)
        batch_selected = []
        for b in range(B):
            min_dist = [np.inf] * len(possible_next_indices)
            selected = [possible_next_indices[always_selected[0]]]
            selected_embs = [embs[b, always_selected[0]]]
            for i in range(1, n):
                for f in range(len(min_dist)):
                    d = float(((selected_embs[-1] - embs[b][f]) ** 2).sum())
                    min_dist[f] = min(min_dist[f], d)
                if i < len(always_selected):
                    best = always_selected[i]
                else:
                    best = int(np.argmax(min_dist))
                selected.append(possible_next_indices[best])
                selected_embs.append(embs[b, best])
            batch_selected.append(selected)
        return batch_selected

    def __next__(self):
        if self._num_obs == 0 and self._current_step == 0:
            obs, latent = SamplingSchemeBase.__next__(self)
            if self.B is None:
                B = len(self.videos)
                return [obs] * B, [latent] * B
            return obs, latent
        if self.is_done():
            raise StopIteration
        obs_frame_indices, latent_frame_indices = self.next_indices()
        assert isinstance(obs_frame_indices, list) and isinstance(latent_frame_indices, list)
        for idx in np.asarray(obs_frame_indices).flatten():
            assert idx in self._done_frames, (
                f"Attempting to condition on frame {idx} before it is generated."
            )
        assert all(i < self._video_length for i in latent_frame_indices)
        self._done_frames.update(latent_frame_indices)
        self._current_step += 1
        return obs_frame_indices, [latent_frame_indices] * len(obs_frame_indices)


class AdaptiveAutoregressive(AdaptiveSamplingSchemeBase):
    def next_indices(self):
        if not self._done_frames:
            return [[]] * len(self.videos), list(range(self._max_frames))
        first = max(self._done_frames) + 1
        latent = list(range(first, min(first + self._step_size, self._video_length)))
        possible = sorted(self._done_frames, reverse=True)
        n_obs = self._max_frames - self._step_size
        obs = self.select_obs_indices(possible, n_obs)
        return obs, latent


class AdaptiveHierarchyNLevel(AdaptiveSamplingSchemeBase, HierarchyNLevel):
    """Hierarchy latents; conditioning = forced nearest frames + adaptive rest."""

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

        obs = [i for i in range(min(latent), max(latent)) if i in self._done_frames]
        remaining = n_cond - len(obs)
        if remaining < 2:
            if self._step_size == 1:
                raise RuntimeError("cannot condition before and after even with step size 1")
            self._step_size -= 1
            try:
                return self.next_indices()
            finally:
                self._step_size += 1

        # force the two closest done frames before and one after the latents
        i = min(latent)
        while i not in self._done_frames:
            i -= 1
        obs.append(i)
        i -= 1
        while i not in self._done_frames:
            i -= 1
        obs.append(i)
        i = max(latent)
        while i < self._video_length and i not in self._done_frames:
            i += 1
        if i < self._video_length:
            obs.append(i)

        possible = list(self._done_frames)
        always = [possible.index(i) for i in obs]
        obs = self.select_obs_indices(possible, n=n_cond, always_selected=always)

        self.last_sampled_idx = max(latent)
        return obs, latent


def make_hierarchy(n: int, adaptive: bool = False):
    base = AdaptiveHierarchyNLevel if adaptive else HierarchyNLevel

    class _Hierarchy(base):
        N = n

    _Hierarchy.__name__ = f"{'Adaptive' if adaptive else ''}Hierarchy{n}Level"
    return _Hierarchy


sampling_schemes = {
    "autoreg": Autoregressive,
    "long-range": LongRangeAutoregressive,
    "hierarchy-2": make_hierarchy(2),
    "hierarchy-3": make_hierarchy(3),
    "hierarchy-4": make_hierarchy(4),
    "hierarchy-5": make_hierarchy(5),
    "adaptive-autoreg": AdaptiveAutoregressive,
    "adaptive-hierarchy-2": make_hierarchy(2, adaptive=True),
    "adaptive-hierarchy-3": make_hierarchy(3, adaptive=True),
}
