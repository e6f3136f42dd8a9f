"""The mean host duration of the program's ``care.beam.step`` span in the
traced window: launching one beam step's work, the loop condition's read
excluded."""

from portbench import spans


def read(ctx):
    red = spans.reduce(ctx.trace)
    if red is None or not red.count.get("care.beam.step"):
        return None
    return 1e6 * red.host_s["care.beam.step"] / red.count["care.beam.step"]
