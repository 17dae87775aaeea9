"""The port's group-sharded engine (DESIGN.md §8) at world 2 and 4 (gloo
ranks, M = 4: two groups a shard, then one) against the port's unsharded
fused engine on the CPU, on six compositions: plain, compressed, robust
with quarantine, drift with a GBP-CS cadence, markov availability under
``bounded_async``, and the lazy population with candidate committees.

The mean of the shards' local means is not bit-equal to the global mean,
so params are held to 1e-5 (1e-3 compressed: a last-bit difference flips
a stochastic int8 rounding, ``test_torch_fused.py``) and round records to
1e-4; the masks, the quarantine counters and staleness clocks,
``reselections``, ``corr``, ``rb``, ``part``, ``stale`` and the byte
ledger are held exactly, and every rank returns the same records and
params."""
import numpy as np
import pytest
import torch

import torch_sharded_ranks as ranks
from test_torch_sharded_jax import assert_matches_reference

ARMS = ("plain", "compress", "robust", "drift", "avail", "population")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def unsharded():
    return {arm: ranks.run_arm(arm) for arm in ARMS}


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request, tmp_path_factory):
    out = tmp_path_factory.mktemp(f"world{request.param}")
    ranks.spawn(request.param, [(arm, ranks.M) for arm in ARMS], str(out))
    return request.param, str(out)


@pytest.mark.parametrize("arm", ARMS)
def test_sharded_matches_unsharded(arm, world, unsharded):
    n, out = world
    got = ranks.load_world(out, arm, ranks.M, n)
    assert_matches_reference(arm, unsharded[arm], got)
    recs0, params0, _ = got[0]
    for recs, params, _ in got[1:]:
        assert recs == recs0
        for a, b in zip(params0, params, strict=True):
            assert np.array_equal(a, b)
