"""The port's sharded train step on the recurrent families, on the CPU:
recurrentgemma (three ``rec`` layers, the RG-LRU scan forward and backward
on each rank's local shard) and xlstm, each on 4 gloo ranks on a (2, 2)
mesh, against the single-device step and the reference's (the bars and
the harness: ``tests/test_torch_distributed.py``, which holds the dense
and MoE families).
"""

import pytest

from test_torch_distributed import check_sharded_step


@pytest.mark.parametrize("arch", ("recurrentgemma-2b", "xlstm-350m"))
def test_sharded_step_matches_single_device_and_reference(arch):
    check_sharded_step(arch)
