"""Auto-generated CLI surface over the option key space.

Port of ``care_tpu/config/cli.py``.

The reference exposes (nearly) every option as an argparse flag in one big
hand-written parser (reference ``opts.py:15-257``, ``train.py:30-60``).  We
get the same surface mechanically: every key in :func:`default_opt` becomes
a ``--<key>`` argument whose type is inferred from the default value, so any
command line from the reference's ``scripts/*.sh`` grid parses here too.

Arguments default to ``None`` (not the option default) so the caller can
distinguish "explicitly passed" from "absent" and only forward the former as
overrides into :func:`care_tpu_torch.config.get_opt` — preserving the
YAML-overlay cascade for everything the user did not pin on the command line.
"""

import argparse


# keys that are not meaningful as CLI flags (structured TPU-build options
# that have dedicated flags, e.g. --mesh, or are YAML/JSON-only)
_SKIP_KEYS = {"mesh_shape", "final_overrides"}


def add_opt_arguments(parser: argparse.ArgumentParser,
                      defaults: dict = None) -> None:
    """Add one argument per option key not already defined on ``parser``.

    Type inference from the default value:

    * ``bool``  -> ``store_true`` flag (all bool defaults are ``False``),
    * ``list``  -> ``nargs='+'`` with the element type (``str`` if empty),
    * ``int`` / ``float`` / ``str`` -> that type,
    * ``None``  -> ``str`` (free-form keys such as ``--pointer``).
    """
    if defaults is None:
        from care_tpu_torch.config.defaults import default_opt
        defaults = default_opt()
    for key, value in defaults.items():
        if key in _SKIP_KEYS or ("--" + key) in parser._option_string_actions:
            continue
        if isinstance(value, bool):
            parser.add_argument("--" + key, action="store_true", default=None)
        elif isinstance(value, list):
            elem_t = type(value[0]) if value else str
            parser.add_argument("--" + key, nargs="+", type=elem_t,
                                default=None)
        elif isinstance(value, (int, float)):
            parser.add_argument("--" + key, type=type(value), default=None)
        else:
            parser.add_argument("--" + key, type=str, default=None)


def overrides_from_args(args: argparse.Namespace,
                        exclude: tuple = ()) -> dict:
    """Collect explicitly-passed CLI values as an overrides dict."""
    return {k: v for k, v in vars(args).items()
            if v not in (None, "") and k not in exclude}
