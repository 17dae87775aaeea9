"""The ported CLI over the lazy population (DESIGN.md §17) composed with
the scenario layers, against the JAX CLI, in-process, on the smoke
command with ``--devices 1000 --reselect-every 2`` and ``--engine host``
(both CLIs' host loops read the device stream over the population):
markov availability under ``bounded_async`` with blind selection (§14),
the robust layer with quarantine (§15) and a redraw drift (§13). Each
schedule is hashed on the seated population ids. The round lines to 1e-4
with ``resel``, ``part``, ``stale``, ``corr`` and ``rb`` equal, and the
``--log-json`` telemetry (``tests/test_torch_population_cli.py``'s
``assert_matches``)."""
import pytest
import torch

from test_torch_population_cli import POP, assert_matches, jax_cli_runs

ARMS = {
    "avail": POP + ["--avail", "markov", "--avail-up-prob", "0.6", "--sync",
                    "bounded_async", "--avail-selection", "blind"],
    "robust": POP + ["--corrupt", "scale+nan_burst", "--corrupt-frac",
                     "0.25", "--quarantine-limit", "2", "--robust-agg",
                     "trimmed_mean"],
    "drift": POP + ["--drift", "redraw", "--drift-period", "2"],
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_cli(tmp_path_factory):
    return jax_cli_runs(tmp_path_factory, ARMS)


@pytest.mark.parametrize("arm", list(ARMS))
def test_population_composed_cli_matches_reference(arm, jax_cli, capsys,
                                                   tmp_path):
    recs = assert_matches(*jax_cli[arm], ARMS[arm], capsys, tmp_path)
    if arm == "avail":      # members that missed an iteration were seated
        assert sum(rec["dark_selected"] for rec in recs) > 0
    if arm == "robust":
        assert sum(rec["corrupted_selected"] for rec in recs) > 0
