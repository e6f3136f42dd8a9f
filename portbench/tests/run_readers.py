"""Read one metric the way ``run.py`` reads it, by its file (tests)."""

from portbench import lookup


def read(name, ctx):
    return lookup.reader(name)(ctx)
