"""The benchmark's own tests: run on the CPU at small sizes, from the root
of the repository (``python -m pytest benchmark/tests``).  Tests marked
``cuda`` decide inside the test whether a card is there."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
