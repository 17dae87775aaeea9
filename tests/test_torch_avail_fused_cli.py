"""The ported CLI's ``--engine fused`` under availability (DESIGN.md §14)
against the JAX CLI's ``--engine fused``, in-process, on the smoke command:
the three flag sets of ``tests/test_torch_avail_cli.py`` (its comparison:
round lines to 1e-4, ``part``, ``stale``, ``resel``, ``corr`` and ``rb``
equal, the byte ledger equal), the availability trace drawn at the t
staged with each round's keys."""
import pytest
import torch

from test_torch_avail_cli import ARMS, assert_matches, jax_cli_runs


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_fused(tmp_path_factory):
    return jax_cli_runs(tmp_path_factory, "fused")


@pytest.mark.parametrize("arm", list(ARMS))
def test_avail_fused_cli_matches_reference(arm, jax_fused, capsys, tmp_path):
    recs = assert_matches(*jax_fused[arm], ARMS[arm] + ["--engine", "fused"],
                          capsys, tmp_path)
    if arm == "composed":
        assert sum(rec["corrupted_selected"] for rec in recs) > 0
        assert sum(rec["dark_selected"] for rec in recs) > 0
