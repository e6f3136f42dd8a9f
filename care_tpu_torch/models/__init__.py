"""The port's models. ``Captioner`` and ``build_captioner`` are loaded on
first use, so that a submodule (``models.common``) imports without the
whole framework (``pretreatment/clip.py`` builds on ``models.common``, and
the framework's backbone on ``pretreatment/clip.py``)."""

__all__ = ["Captioner", "build_captioner"]


def __getattr__(name):
    if name in __all__:
        from care_tpu_torch.models import framework
        return getattr(framework, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
