"""The rank body of tests/test_torch_port_utils.py's two-rank gloo test.

`parallel/launch.spawn` re-imports a rank function's module in every
rank, so the function lives here, in a module that imports neither JAX
nor the JAX package: each rank then loads only torch and the port.
"""

import numpy as np

from bigdl_tpu_torch.dataset import spark_adapter as pspark
from bigdl_tpu_torch.utils import Engine


def rank_view(rank, world):
    """Engine's and the Spark adapter's view from one rank of a gloo
    group (runs in a process of its own)."""
    rows = [(np.ones(3) * i, i % 2) for i in range(10)]
    Engine.init_distributed()           # a group exists: left as it is
    ds = pspark.rdd_to_dataset(rows)
    return (Engine.node_number(), Engine.device_count(),
            [float(s.feature[0]) for s in ds.elements])
