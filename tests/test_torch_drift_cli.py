"""The ported CLI under the dynamic environments (DESIGN.md §13) against
the JAX CLI, in-process, on the smoke command: the round lines to 1e-4
with ``resel`` equal, and ``--log-json``'s ``group_discrepancy``,
``divergence``, ``selection_distance`` (to 1e-4) and ``reselections``
(equal).

Three JAX CLI runs serve five port runs: the JAX CLI prints the same
lines on ``--engine host`` and ``--engine fused`` for these flags (its
engines share one environment, ``tests/test_drift.py``), so the port's
host loop and fused engine are both held to one JAX run of ``--drift
redraw``, and both baseline engines to one of ``--strategy fedavg --drift
churn``."""
import contextlib
import io
import json
import sys
from unittest import mock

import pytest
import torch

from repro_torch.launch import train
from test_torch_train import COUNTED, SMOKE, _rounds

REDRAW = ["--drift", "redraw", "--drift-period", "2", "--reselect-every",
          "2"]
STEP = ["--drift", "step_shift", "--drift-t0", "3", "--reselect-every", "0",
        "--engine", "fused"]
CHURN = ["--strategy", "fedavg", "--drift", "churn", "--drift-period", "3"]
FIELDS = ("group_discrepancy", "divergence", "selection_distance")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_cli(tmp_path_factory):
    """The JAX CLI's round lines and ``--log-json`` records, once per
    flag set."""
    from repro.launch import train as jtrain
    out = {}
    for name, flags in (("redraw", REDRAW), ("step", STEP),
                        ("churn", CHURN)):
        log = tmp_path_factory.mktemp(f"jax_{name}") / "log.json"
        buf = io.StringIO()
        with mock.patch.object(sys, "argv", ["train"] + SMOKE + flags
                               + ["--log-json", str(log)]), \
                contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            jtrain.main()
        out[name] = (_rounds(buf.getvalue()), json.loads(log.read_text()))
    return out


@pytest.mark.parametrize("arm,flags", [
    ("redraw", REDRAW), ("redraw", REDRAW + ["--engine", "fused"]),
    ("step", STEP), ("churn", CHURN), ("churn", CHURN + ["--engine", "fused"]),
], ids=["redraw-host", "redraw-fused", "step_shift-fused", "churn-host",
        "churn-fused"])
def test_drift_cli_matches_reference(arm, flags, jax_cli, capsys):
    ref, ref_recs = jax_cli[arm]
    capsys.readouterr()
    recs = train.main(SMOKE + flags + ["--device", "cpu"])
    out = _rounds(capsys.readouterr().out)
    assert len(ref) == len(out) == 3
    for r, o in zip(ref, out):
        assert [k for k, _ in r] == [k for k, _ in o]
        for (key, rv), (_, ov) in zip(r, o):
            if key in COUNTED:
                assert rv == ov, (key, rv, ov)
            else:
                assert abs(float(rv) - float(ov)) <= 1e-4, (key, rv, ov)
    for r, o in zip(ref_recs, recs, strict=True):
        assert r["reselections"] == o["reselections"]
        for name in FIELDS:
            if r[name] is None:
                assert o[name] is None
            else:
                assert abs(r[name] - o[name]) <= 1e-4, (name, r, o)
    if arm == "step":
        # static super nodes: one rebuild, at t = 0
        assert [rec["reselections"] for rec in recs] == [1.0, 0.0, 0.0]


def test_drift_flags_parse_and_warn(capsys):
    """The JAX CLI's defaults; a baseline strategy warns that
    ``--reselect-every`` is FedGS-only."""
    args = train.build_parser().parse_args([])
    assert (args.drift, args.drift_t0, args.drift_period, args.drift_alpha,
            args.drift_churn, args.reselect_every) == \
        ("static", 50, 50, 0.3, 0.25, 1)
    assert train.drift_config(args) is None
    with pytest.raises(SystemExit):
        train.build_parser().parse_args(["--drift", "sudden"])
    small = ["--device", "cpu", "--groups", "2", "--devices-per-group", "4",
             "--selected", "2", "--presampled", "1", "--iters", "1",
             "--rounds", "1", "--batch-size", "2", "--smoke-model",
             "--local-steps", "1", "--eval-every", "5"]
    capsys.readouterr()
    train.main(small + ["--strategy", "fedavg", "--reselect-every", "3"])
    assert "--reselect-every applies only to --strategy fedgs" in \
        capsys.readouterr().err
