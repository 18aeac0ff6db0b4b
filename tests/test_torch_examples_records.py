"""The port's imagenet_records_pipeline example on the CPU: the BDLS
shards written, the CIFAR ResNet-8 trained from disk through the C++
prefetcher, held to the example's own expectation (its four classes are
separable and augmentation-invariant: the JAX example reaches 1.000).
The JAX example takes ~37 s on one CPU core, so it is not run beside
it. Tolerance: accuracy >= 0.9; the printed lines the JAX example's
but for the temporary directory."""

import test_torch_examples_common as common
import test_torch_examples_ranks as ranks

PREFIX = "accuracy from disk-fed training:"


def test_imagenet_records_pipeline():
    acc, out = ranks.run_example("imagenet_records_pipeline",
                                 ranks.no_patch())
    (got,) = common.printed_numbers(out, PREFIX)
    assert got == round(acc, 3) and got >= 0.9
    lines = out.splitlines()
    assert len(lines) == 3
    assert lines[0].startswith("wrote 4 shards under ")
    assert lines[1] == "native plane: True; 512 samples (32, 32, 3)"
