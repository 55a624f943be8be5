"""The Gaussian cache's hit share (%): the program's `cache.hits` counter
over its hits and `cache.misses`, the context pairs of every traced step
(`training/trainer_cached.py::CachedGGRtTrainer.train_iteration`)."""
from benchmark import program_counters


def read(rec):
    hits = sum(program_counters.per_item(rec, "cache.hits"))
    pairs = hits + sum(program_counters.per_item(rec, "cache.misses"))
    return 100.0 * hits / pairs if pairs else None
