"""Seconds of ``Dataset.from_arrays`` in set-up, by the benchmark's host
clock: the port's host binning of the generated table."""


def read(ctx):
    return getattr(ctx, "bin_s", None)
