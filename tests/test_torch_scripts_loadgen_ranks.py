"""Rank body for tests/test_torch_scripts_loadgen_tp.py: the port's
load-generator report (bigdl_tpu_torch/scripts/loadgen.py `run`) on one
rank of a gloo group, as `torchrun ... -m bigdl_tpu_torch.scripts.
loadgen --tp N` runs it. This module imports neither JAX nor the JAX
package: parallel/launch.spawn re-imports it in every rank.
"""

import json

from bigdl_tpu_torch.scripts import loadgen


def rank_report(rank, world, argv, weights):
    return json.dumps(loadgen.run(argv, weights=weights), sort_keys=True)
