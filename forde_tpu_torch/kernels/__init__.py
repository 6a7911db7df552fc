"""Hand-written CUDA kernels: build (``kernels.build``) and launch counts.

Every kernel wrapper adds one to ``launches[<kernel name>]`` right after
it launches its kernel, and nowhere else, so a run can show that its main
path went through the kernels. ``reset_launches`` sets every count to 0.
"""

from __future__ import annotations

import collections

launches: collections.Counter = collections.Counter()


def reset_launches() -> None:
    launches.clear()
