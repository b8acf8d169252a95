"""supersteps_per_query.batch: push supersteps over the window, summed
over the pool driver's level records (``TopkRunner.last_level_stats``,
every block of every level run), per query answered."""


def read(run):
    if not run.records or not run.answered:
        return None
    return sum(st["supersteps"] for st in run.records) / run.answered
