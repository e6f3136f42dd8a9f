"""The loops a measured window runs (``drivers/<name>.py``, a ``Driver``
each), named by a mix's ``driver``."""
