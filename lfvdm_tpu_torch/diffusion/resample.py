"""Timestep schedule samplers (importance sampling over t): a copy of
lfvdm_tpu/diffusion/resample.py.

Host-side numpy objects that draw the per-batch timesteps of the train step.
The loss-aware sampler's update gathers every process's (t, loss) pairs in
rank order first, so each rank applies the same update and holds the same
weights.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np

from ..utils.device import process_index_and_count


def create_named_schedule_sampler(name: str, diffusion):
    if name == "uniform":
        return UniformSampler(diffusion)
    if name == "loss-second-moment":
        return LossSecondMomentResampler(diffusion)
    raise NotImplementedError(f"unknown schedule sampler: {name}")


class ScheduleSampler(ABC):
    """A distribution over timesteps, used for unbiased importance sampling."""

    @abstractmethod
    def weights(self) -> np.ndarray:
        """Unnormalized positive weights, one per diffusion step."""

    def sample(self, batch_size: int, rng: np.random.Generator):
        """Draw (timesteps, importance_weights) as numpy arrays."""
        w = self.weights()
        p = w / np.sum(w)
        indices = rng.choice(len(p), size=(batch_size,), p=p)
        weights = 1.0 / (len(p) * p[indices])
        return indices.astype(np.int32), weights.astype(np.float32)


class UniformSampler(ScheduleSampler):
    def __init__(self, diffusion):
        self.diffusion = diffusion
        self._weights = np.ones([diffusion.num_timesteps])

    def weights(self):
        return self._weights


class LossAwareSampler(ScheduleSampler):
    def update_with_local_losses(self, local_ts, local_losses):
        """Update the reweighting from this process's (t, loss) pairs,
        gathered from every process of a ``torch.distributed`` group in rank
        order (every rank must call it at the same step)."""
        ts = np.asarray(local_ts).reshape(-1)
        losses = np.asarray(local_losses).reshape(-1)
        if process_index_and_count()[1] > 1:
            import torch.distributed as dist

            gathered = [None] * dist.get_world_size()
            dist.all_gather_object(gathered, (ts, losses))
            ts = np.concatenate([g[0] for g in gathered])
            losses = np.concatenate([g[1] for g in gathered])
        self.update_with_all_losses([int(t) for t in ts], [float(l) for l in losses])

    @abstractmethod
    def update_with_all_losses(self, ts, losses):
        """Apply a deterministic update from globally-gathered (t, loss) pairs."""


class LossSecondMomentResampler(LossAwareSampler):
    """Weights ∝ sqrt(E[loss²]) over a 10-deep per-t history, with a uniform floor."""

    def __init__(self, diffusion, history_per_term: int = 10, uniform_prob: float = 0.001):
        self.diffusion = diffusion
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob
        self._loss_history = np.zeros(
            [diffusion.num_timesteps, history_per_term], dtype=np.float64
        )
        self._loss_counts = np.zeros([diffusion.num_timesteps], dtype=np.int64)

    def weights(self):
        if not self._warmed_up():
            return np.ones([self.diffusion.num_timesteps], dtype=np.float64)
        weights = np.sqrt(np.mean(self._loss_history**2, axis=-1))
        weights /= np.sum(weights)
        weights *= 1 - self.uniform_prob
        weights += self.uniform_prob / len(weights)
        return weights

    def update_with_all_losses(self, ts, losses):
        for t, loss in zip(ts, losses):
            if self._loss_counts[t] == self.history_per_term:
                self._loss_history[t, :-1] = self._loss_history[t, 1:]
                self._loss_history[t, -1] = loss
            else:
                self._loss_history[t, self._loss_counts[t]] = loss
                self._loss_counts[t] += 1

    def _warmed_up(self):
        return (self._loss_counts == self.history_per_term).all()
