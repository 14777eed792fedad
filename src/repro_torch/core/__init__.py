"""core: the paper's contribution (iRT + iRC, ``remap``), the policy layer
(``policy``) and the trace-driven simulator that evaluates them; port of
``repro.core``."""

from .config import (IDENTITY, SimConfig, alloy, ideal, linear_cache, lohhill,
                     mempod, trimma_cache, trimma_flat)
from .policy import (PRESETS, PolicyConfig, get_policy, mea_policy,
                     on_demand_policy, recency_policy, threshold_policy,
                     topk_policy, write_aware_policy)
from .simulator import (derive_metrics, make_geometry, metadata_blocks, run,
                        run_many)
from .timing import DDR5_NVM, HBM3_DDR5, TIMINGS, TimingModel
from .traces import (WORKLOADS, TraceSpec, generate_trace,
                     relabel_first_touch, with_deallocs)

__all__ = [
    "IDENTITY", "SimConfig", "alloy", "ideal", "linear_cache", "lohhill",
    "mempod", "trimma_cache", "trimma_flat", "run", "run_many",
    "derive_metrics", "metadata_blocks", "make_geometry", "TimingModel",
    "HBM3_DDR5", "DDR5_NVM", "TIMINGS", "WORKLOADS", "TraceSpec",
    "generate_trace", "relabel_first_touch", "with_deallocs",
    "PolicyConfig", "get_policy", "PRESETS", "threshold_policy",
    "mea_policy", "on_demand_policy", "write_aware_policy", "topk_policy",
    "recency_policy",
]
