"""The port's multi-process path (numpywren_tpu_torch.parallel.distributed),
after tests/test_distributed.py: the JAX package joins processes through
its coordination service, the port through torch.distributed. Here 8 ranks
of one gloo group on localhost, joined through NPW_COORDINATOR /
NPW_NUM_PROCESSES / NPW_PROCESS_ID, run tests/torch_parallel_worker.py's
"distributed" checks (host-0 broadcast, sharded Cholesky 512/64 with
residual < 1e-4, sharded GEMM within 1e-4 of fp64, each rank binding only
its own rows, gather_to_hosts, a final barrier); and in a single process
every helper is a no-op."""

import numpy as np

from torch_parallel_worker import launch


def test_multi_process_mesh(tmp_path):
    launch("distributed", 8, str(tmp_path))


def test_single_process_degrades():
    """distributed.* helpers are no-ops in a plain single-process run, so
    library code never needs to branch."""
    import torch

    from numpywren_tpu_torch.parallel import distributed

    assert distributed.initialize() is False  # no coordinator configured
    assert distributed.process_count() == 1
    assert distributed.process_index() == 0
    assert not distributed.is_multi_host()
    distributed.sync()
    x = np.arange(4.0)
    assert distributed.broadcast_from_host0(x) is x
    np.testing.assert_array_equal(distributed.gather_to_hosts(x), x)
    t = torch.arange(3.0)
    np.testing.assert_array_equal(distributed.gather_to_hosts(t), t.numpy())
