"""AL iterations the cohort completes per second, by the window rule
(``benchmark.stats``): each iteration that overlaps the window counts
with the share of it inside."""


def read(ctx):
    return ctx.iterations / ctx.seconds if ctx.iterations > 0 else None
