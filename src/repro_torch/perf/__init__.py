"""Measurement tools for the port's kernels on the card, and the models
that read the card's constants (``roofline.py``, where those constants
live, and the decode planner ``autotune.py``).

``HBM_BYTES_PER_S`` and ``PEAK_FLOPS`` are ``roofline``'s, under the names
that older trees' ``perf/decode_times.py`` imports (a checkout of another
commit is timed with this tree's script).
"""

from repro_torch.perf.roofline import HBM_BW as HBM_BYTES_PER_S
from repro_torch.perf.roofline import PEAK_FLOPS

__all__ = ["HBM_BYTES_PER_S", "PEAK_FLOPS"]
