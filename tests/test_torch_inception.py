"""Full-depth Inception-v1 (BASELINE config 3): the port's
bigdl_tpu_torch/models/inception.py `build()` against the JAX
package's at 224 x 224 x 3, batch 1, in training mode with Dropout's p
set to 0 on both sides, on one seeded variable tree (the helpers and
tolerances of tests/test_torch_cnn_zoo.py).

The fp32 forward is held at rtol 1e-4 / atol 1e-5. The gradients are
held in fp64, within 1e-10 of each leaf's largest entry: fp32
gradients of a deep ReLU network are discontinuous at their rounding
level (a ReLU input within rounding of zero flips between two
summation orders), and the two packages' fp32 gradients read up to
4.3e-3 apart where their fp64 gradients read 2.6e-15 apart. This file
stands apart from the zoo's to keep each under 30 s on one core.
"""

from bigdl_tpu import nn as jnn
from bigdl_tpu.models import inception as jinception
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models import inception as tinception

import test_torch_cnn_zoo as zoo


def _models():
    return (zoo._p0(jinception.build(1000), jnn),
            zoo._p0(tinception.build(1000), tnn))


def test_inception_v1_full_depth_forward_matches_jax():
    jm, tm = _models()
    out, _ = zoo._check(jm, tm, [zoo._images((1, 224, 224, 3), 5)],
                        training=True, grads=False)
    assert out.shape == (1, 1000)


def test_inception_v1_full_depth_grads_match_jax_in_fp64():
    jm, tm = _models()
    zoo._check(jm, tm, [zoo._images((1, 224, 224, 3), 5)], training=True,
               fp64=True)
