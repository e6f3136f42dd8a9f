"""The model's weights, made from the seed (``weights/<name>.py``), named by
a configuration's ``weights``."""
