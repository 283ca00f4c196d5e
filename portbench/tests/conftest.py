"""The benchmark's own tests: ``python -m pytest portbench/tests`` from the
root of the checkout (CPU); ``-m cuda`` for the ones that need a card."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)
