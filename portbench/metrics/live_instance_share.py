"""The share of the measured window's instance steps (each instance in
each beam step it takes part in, ``translator.instance_steps``) in which
the instance was still live, its finished buffer not yet full
(``translator.live_instance_steps``)."""


def read(ctx):
    total = ctx.counts.get("translator.instance_steps", 0)
    if not total:
        return None
    return 100.0 * ctx.counts.get("translator.live_instance_steps", 0) / total
