"""The inputs of a mix, made from the seed (``generators/<name>.py``),
named by a mix's ``generator``."""
