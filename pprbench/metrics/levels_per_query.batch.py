"""levels_per_query.batch: level runs per query answered over the window:
each level record's pending queries (those that ran the level), summed,
over the queries answered.  The split accept decides how deep each query
goes."""


def read(run):
    if not run.records or not run.answered:
        return None
    return sum(st["pending"] for st in run.records) / run.answered
