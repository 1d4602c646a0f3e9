"""``python -m eigen_value`` — the reference ``./run`` analog.

Defers to the bench driver (`bench/__main__.py`), which prints the same
fixed-width report tables as the reference binary (main.cpp:7-162).
"""

import sys

from .bench.__main__ import main

if __name__ == "__main__":
    sys.exit(main())
