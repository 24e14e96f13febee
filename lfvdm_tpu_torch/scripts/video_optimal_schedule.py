"""Write the ``optimal_schedule.pt`` that ``video_sample --optimality`` reads
(counterpart of the repo's scripts/video_optimal_schedule.py).

    python -m lfvdm_tpu_torch.scripts.video_optimal_schedule --eval_dir DIR \\
        --sampling_scheme autoreg --optimality index --T 300 --max_frames 20

The file is a dict from step number to the sorted list of observed frame
indices at that step, overriding the scheme's own conditioning choice there.
The base scheme is dry-run once to record, per step, the frames already
generated (the candidate pool), how many conditioning slots it uses and which
frames it generates; then each step's observed frames are chosen again:

  --optimality index       the done frames closest in time to the latent
                           frames. Data-free.
  --optimality lpips       the highest mean LPIPS-embedding similarity to the
                           latent frames, averaged over --num_videos training
                           videos of --dataset (the port's LPIPS embedder, on
                           --device; a seeded random backbone unless
                           $LFVDM_LPIPS_WEIGHTS names the weights).
  --optimality linspace-t  pool frames nearest to evenly spaced times.
  --optimality random-t    distinct random pool frames (per --seed and step).
  --optimality {linspace-t,random-t}-force-nearby
                           the nearest done frame on each side of the latent
                           block first, the rest by the base strategy.

Every chosen index comes from that step's pool of done frames, so the
scheme's "condition only on generated frames" check holds by construction.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..sampling.schemes import sampling_schemes

REFERENCE_STRATEGIES = ("linspace-t", "random-t",
                        "linspace-t-force-nearby", "random-t-force-nearby")


def dry_run_scheme(scheme_name, T, n_obs, max_frames, step_size):
    """One pass of the base scheme: per step (candidate done frames, number
    of obs slots used, latent indices)."""
    scheme = sampling_schemes[scheme_name](
        video_length=T, num_obs=n_obs, max_frames=max_frames, step_size=step_size)
    steps = []
    for step, (obs, latent) in enumerate(scheme):
        done_before = sorted(scheme._done_frames - set(latent))
        steps.append({"step": step, "pool": done_before,
                      "n_slots": len(obs), "latent": list(latent)})
    return steps


def score_index(pool, latent):
    """-min temporal distance to any latent frame (higher = closer)."""
    lat = np.asarray(latent)
    return np.array([-np.abs(lat - i).min() for i in pool], dtype=np.float64)


def score_lpips(pool, latent, sim):
    """Mean embedding similarity candidate->latent (dataset-averaged)."""
    return sim[np.ix_(pool, latent)].mean(axis=1)


def pick_linspace_t(pool, n_slots, rng=None):
    """Nearest pool frame to each of n_slots evenly spaced time targets."""
    pool = list(pool)
    targets = np.linspace(min(pool), max(pool), n_slots)
    chosen = []
    for tgt in targets:
        free = [p for p in pool if p not in chosen]
        if not free:
            break
        chosen.append(min(free, key=lambda p: (abs(p - tgt), p)))
    return chosen


def pick_random_t(pool, n_slots, rng):
    pool = list(pool)
    take = min(n_slots, len(pool))
    return [int(i) for i in rng.choice(pool, size=take, replace=False)]


def pick_force_nearby(pool, latent, n_slots, base_pick, rng):
    """Force the nearest done frame on each side of the latent block, then
    fill the remaining slots with the base strategy over the rest."""
    pool = list(pool)
    lo, hi = min(latent), max(latent)
    forced = []
    before = [p for p in pool if p < lo]
    after = [p for p in pool if p > hi]
    if before:
        forced.append(max(before))
    if after and len(forced) < n_slots:
        forced.append(min(after))
    rest_pool = [p for p in pool if p not in forced]
    n_rest = n_slots - len(forced)
    rest = base_pick(rest_pool, n_rest, rng) if n_rest > 0 and rest_pool else []
    return forced + list(rest)


def embedding_similarity(dataset_name, T, num_videos, image_size, device="cuda"):
    """(T, T) frame-pair cosine similarity of the LPIPS embeddings, averaged
    over the first ``num_videos`` training videos."""
    from ..data.datasets import _build_dataset
    from ..evals.lpips import LpipsEmbedder

    ds = _build_dataset(dataset_name, T, train=True, shard=0, num_shards=1)
    emb = LpipsEmbedder(image_size=image_size, device=device)
    sims = []
    for v in range(min(num_videos, len(ds))):
        video = np.asarray(ds[v])[:T]  # (T, C, H, W) in [-1, 1]
        e = emb(video)  # (T, E)
        e = e / (np.linalg.norm(e, axis=1, keepdims=True) + 1e-10)
        sims.append(e @ e.T)
    return np.mean(sims, axis=0)


def build_schedule(steps, scorer=None, picker=None):
    """Per step: top-n_slots candidates by ``scorer`` (stable argsort on
    -score, ties toward temporal order), or a direct ``picker(pool, latent,
    n_slots, step)`` for the reference-named strategies."""
    schedule = {}
    for s in steps:
        if s["n_slots"] == 0 or not s["pool"]:
            continue  # unconditional step: nothing to override
        if picker is not None:
            chosen = picker(s["pool"], s["latent"], s["n_slots"], s["step"])
        else:
            scores = scorer(s["pool"], s["latent"])
            order = np.argsort(-scores, kind="stable")[: s["n_slots"]]
            chosen = [s["pool"][i] for i in order]
        schedule[s["step"]] = sorted(int(i) for i in chosen)
    return schedule


def make_reference_picker(optimality, seed):
    """Picker for one of the reference's four declared strategy names."""
    base = pick_linspace_t if optimality.startswith("linspace") else pick_random_t
    force = optimality.endswith("-force-nearby")

    def picker(pool, latent, n_slots, step):
        rng = np.random.default_rng(seed + step)  # deterministic per step
        if force:
            return pick_force_nearby(pool, latent, n_slots, base, rng)
        return base(pool, n_slots, rng)

    return picker


def create_argparser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--eval_dir", required=True,
                    help="directory video_sample.py will be pointed at; "
                         "optimal_schedule.pt is written here")
    ap.add_argument("--sampling_scheme", required=True,
                    choices=sorted(sampling_schemes))
    ap.add_argument("--optimality", default="index",
                    choices=["index", "lpips", *REFERENCE_STRATEGIES])
    ap.add_argument("--seed", type=int, default=0,
                    help="determinism for the random-t strategies")
    ap.add_argument("--T", type=int, required=True)
    ap.add_argument("--n_obs", type=int, default=0)
    ap.add_argument("--max_frames", type=int, required=True)
    ap.add_argument("--step_size", type=int, default=1)
    ap.add_argument("--dataset", default="synthetic",
                    help="training split used for --optimality lpips statistics")
    ap.add_argument("--num_videos", type=int, default=8)
    ap.add_argument("--image_size", type=int, default=64)
    ap.add_argument("--device", type=str, default="cuda",
                    help="the device of the LPIPS embedder (--optimality lpips): cuda "
                         "(default) or cpu")
    return ap


def main(argv=None):
    """Run the CLI on ``argv`` (default: the command line); returns the path
    of the written ``optimal_schedule.pt``."""
    args = create_argparser().parse_args(argv)
    steps = dry_run_scheme(args.sampling_scheme, args.T, args.n_obs,
                           args.max_frames, args.step_size)
    if args.optimality in REFERENCE_STRATEGIES:
        schedule = build_schedule(
            steps, picker=make_reference_picker(args.optimality, args.seed))
    elif args.optimality == "index":
        schedule = build_schedule(steps, scorer=score_index)
    else:
        sim = embedding_similarity(args.dataset, args.T, args.num_videos,
                                   args.image_size, device=args.device)
        schedule = build_schedule(
            steps, scorer=lambda pool, latent: score_lpips(pool, latent, sim))
    out_dir = Path(args.eval_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / "optimal_schedule.pt"
    torch.save(schedule, out)
    print(f"wrote {out}: {len(schedule)} steps "
          f"(scheme={args.sampling_scheme}, optimality={args.optimality})")
    return out


if __name__ == "__main__":
    main()
