"""The port's counterpart of ``__graft_entry__.py::dryrun_multichip`` and
``parallel.multihost`` on the CPU.

  - ``fora_tpu_torch.dryrun.dryrun_multichip`` on 8 CPU devices (graph 4 x
    query 2): the raw one-shot, the pool under routed and hier, and the
    same pool from both stores, with the reference's assertions; on 3
    devices (one query group, no hier) too;
  - ``gather_to_host`` equal to the concatenation of the shards' rows
    without a process group; ``init``'s refusals, made before it opens
    the coordinator's store (``tests/test_torch_multihost.py`` starts
    groups across processes).
"""

import numpy as np
import pytest
import torch

from fora_tpu_torch.dryrun import dryrun_multichip, main
from fora_tpu_torch.parallel import multihost

torch.set_num_threads(2)


def test_dryrun_multichip_eight_cpu_devices():
    out = dryrun_multichip(["cpu"] * 8)
    assert out["mesh"] == {"graph": 4, "query": 2}
    assert out["exchanges"] == ["routed", "hier"]
    assert out["store_backed"] == ["routed", "hier"]
    assert out["pool_levels"]["routed"] == out["pool_levels"]["hier"] >= 1
    assert out["push_iters"] > 0


def test_dryrun_multichip_three_devices(capsys):
    assert main(["3", "--device", "cpu"]) == 0
    line = capsys.readouterr().out
    assert line.startswith("dryrun_multichip ok: mesh={'graph': 3, "
                           "'query': 1}")
    assert "exchanges=['routed']" in line


def test_gather_to_host_concatenates_rows():
    rng = np.random.default_rng(1)
    shards = [torch.as_tensor(rng.random((5, 3)).astype(np.float32))
              for _ in range(4)]
    got = multihost.gather_to_host(shards)
    np.testing.assert_array_equal(got, np.concatenate(
        [s.numpy() for s in shards]))
    one = multihost.gather_to_host(shards[2])
    np.testing.assert_array_equal(one, shards[2].numpy())
    with pytest.raises(ValueError, match="NCCL"):
        multihost.init("localhost:1234", 2, 0, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="process 2 of 2"):
        multihost.init("localhost:1234", 2, 2, backend="gloo")
    assert multihost.comm() is None
