"""The benchmark's tests import `portbench` from the checkout's root and
the program from `src/`, as `portbench/run.py` does."""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
