"""Measurement tools for the port's kernels on the card, the models that
read the card's constants (``roofline.py``, where those constants live,
and the decode planner ``autotune.py``), and the dry run's models: JAX's
compulsory-traffic model (``memory_model.py``) and the ring costing of a
step's logged collectives (``collective_analysis.py``).

``HBM_BYTES_PER_S`` and ``PEAK_FLOPS`` are ``roofline``'s, under the names
that older trees' ``perf/decode_times.py`` imports (a checkout of another
commit is timed with this tree's script).
"""

from repro_torch.perf.roofline import HBM_BW as HBM_BYTES_PER_S
from repro_torch.perf.roofline import PEAK_FLOPS

__all__ = ["HBM_BYTES_PER_S", "PEAK_FLOPS"]
