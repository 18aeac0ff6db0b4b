"""The second half of the serializer catalog (the first half, and the
helpers, are tests/test_torch_module_serializer.py): for each layer,
JAX save -> port load and port save -> JAX load within fp32 rtol 1e-4,
atol 1e-5, and port save -> port load bitwise."""

import pytest

import test_torch_module_serializer as ms


@pytest.mark.parametrize("name", ms.NAMES[ms.HALF:])
def test_module_moves_both_ways(tmp_path, name):
    ms.module_case(tmp_path, name)
