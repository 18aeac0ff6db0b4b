"""The checks of test_torch_distributed.py at world size 4: four gloo
ranks of the port against the JAX package's DistriOptimizer on a mesh of
the first 4 of the 8 CPU devices. At 4 ranks a validation batch of 10
rows does not divide by the axis: the loop pads it to 12 with copies of
its last row, and the Loss edge correction keeps the loss unbiased.
Tolerances as in test_torch_distributed.py.
"""

import pytest

import test_torch_distributed as td


@pytest.fixture(scope="module")
def w4(tmp_path_factory):
    return (4,) + td.run_world(4, tmp_path_factory, with_resume=False)


def test_dp_matches_single_device_sgd(w4):
    world, init, results, _ = w4
    td.check_dp_matches_single_device_sgd(world, init, results)


def test_momentum_slots_stay_sharded(w4):
    world, init, results, _ = w4
    td.check_momentum_slots_stay_sharded(world, init, results)


def test_zero2_bitwise_zero1(w4):
    td.check_zero2_bitwise_zero1(w4[2])


def test_distri_exact_bf16_and_clip_match_jax(w4):
    world, init, results, _ = w4
    td.check_distri_matches_jax(world, init, results)


def test_accumulation_equals_large_batch(w4):
    td.check_accumulation(w4[2])


def test_non_reducible_state_stays_local(w4):
    td.check_state_reduction(w4[0], w4[2])


def test_sync_bn_equals_full_batch_bn(w4):
    td.check_sync_bn(w4[2])


def test_uneven_eval_and_unbiased_loss(w4):
    td.check_uneven_eval(w4[1], w4[2])


def test_bad_batch_size_raises(w4):
    for r in w4[2]:
        assert r["bad_batch"] is not None and "divisible" in r["bad_batch"]


def test_recovery_after_injected_step_fault(w4):
    td.check_recovery(w4[2])
