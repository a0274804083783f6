"""svinet-tpu: stochastic variational inference for the (assortative)
mixed-membership stochastic blockmodel, in JAX.

A JAX/XLA framework with the capabilities of premgopalan/svinet
(overlapping community detection on undirected networks), re-designed for
accelerators: dense vectorized per-edge local steps, scatter-add of
sufficient statistics, and shard_map data parallelism over edge shards
with psum-reduced statistics.
"""

__version__ = "0.1.0"

from svinet_tpu.config import Config
from svinet_tpu.graph import Network

__all__ = ["Config", "Network", "__version__"]
