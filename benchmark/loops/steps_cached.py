"""Gaussian-cached train steps (`CachedGGRtTrainer.train_iteration`), one
after another, as `steps.py` drives the other trainers.

The cached trainer keeps each pair's Gaussians across steps, keyed by the
pair's first frame, and encodes only the pairs missing from the cache,
each with its own depth-sampling draws. Set-up, window, reference and
comparison are `steps.py`'s: this module loads a private copy of it and
replaces that copy's `trainer_class` (the program's or the reference's
cached trainer, with the mix's `cache_capacity`) and `draws` (the step's
draws cut into one (1, 2, h·w, surfaces, gaussians per pixel) tensor a
pair; the i-th pair the cache misses takes the i-th). Program and reference
start from empty caches and see the same examples, so they miss the same
pairs.
"""
from __future__ import annotations

import functools

from benchmark import common, spec

steps = spec.loop("steps")
_draws = steps.draws


def trainer_class(mix: dict, program: bool):
    if program:
        from ggrt_official_torch.training.trainer_cached import CachedGGRtTrainer
    else:
        from benchmark.reference.ggrt.training.trainer_cached import CachedGGRtTrainer
    return functools.partial(CachedGGRtTrainer, cache_capacity=int(mix.get("cache_capacity", 32)))


def draws(ctx: dict, step: int, example: dict) -> list:
    return list(_draws(ctx, step, example).split(1))


def setup(ctx: dict, spans) -> dict:
    st = steps.setup(ctx, spans)
    t = st["trainer"]
    common.note(f"the compared steps' cache: {t.hits} hits, {t.misses} misses")
    return st


steps.trainer_class, steps.draws = trainer_class, draws
item, release, work = steps.item, steps.release, steps.work
check, inputs, sound, control = steps.check, steps.inputs, steps.sound, steps.control
