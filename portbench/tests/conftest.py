"""The benchmark's own tests: ``python -m pytest portbench/tests -q``
from the repository's root (the CPU tests), ``-m gpu`` on the card."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (ROOT, os.path.dirname(os.path.abspath(__file__))):
    if p not in sys.path:
        sys.path.insert(0, p)
