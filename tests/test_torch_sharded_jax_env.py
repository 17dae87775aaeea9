"""The port's group-sharded engine at world 4 against the JAX package's
4-shard run on the dynamic-environment compositions: drift (``redraw``
every 2 iterations, GBP-CS cadence 2), availability (``markov`` churn under
``bounded_async``) and the lazy population (D = 1,000, candidate
committees redrawn every 2). The comparison is ``test_torch_sharded_jax``'s
(DESIGN.md §8, §13, §14, §17.3)."""
import numpy as np
import pytest
import torch

from test_torch_sharded_jax import assert_matches_reference, sharded_runs

ARMS = ("drift", "avail", "population")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return sharded_runs(tmp_path_factory, ARMS)


@pytest.mark.parametrize("arm", ARMS)
def test_world4_matches_jax_4shard_env(arm, runs):
    ref, world = runs[arm]
    assert_matches_reference(arm, ref, world)
    if arm == "avail":
        assert np.any(ref[2]["staleness"] < 4)
        assert min(r["participation"] for r in ref[0]) < 0.9
