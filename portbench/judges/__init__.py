"""The comparisons that decide ``correct`` (``judges/<name>.py``), named by
a configuration's ``judge``."""
