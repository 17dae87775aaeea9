"""The ported CLI under availability (DESIGN.md §14) against the JAX CLI,
in-process, on the smoke command with ``--engine host``: the round lines
to 1e-4 with ``part``, ``stale``, ``resel``, ``corr`` and ``rb`` equal, and
``--log-json``'s ``bytes_int``/``bytes_ext`` equal, for three flag sets —
markov churn under ``bounded_async``, the straggler tail with blind
selection, and markov churn under ``bounded_async`` composed with the
robust layer and the compression. ``tests/test_torch_avail_fused_cli.py``
holds ``--engine fused`` to the JAX CLI's fused lines (the JAX CLI's host
loop reads numpy ``FactoryStreams``, its fused engine the device stream,
so each engine has its own reference lines)."""
import contextlib
import io
import json
import re
import sys
from unittest import mock

import pytest
import torch

from repro_torch.launch import train
from test_torch_train import SMOKE

MARKOV = ["--avail", "markov", "--avail-up-prob", "0.6", "--sync",
          "bounded_async"]
TAIL = ["--avail", "straggler_tail", "--avail-selection", "blind"]
# cadence 2: the keep iterations hold committees whose members go dark,
# so the stale mass enters the robust and compressed Eq. 4
COMPOSED = MARKOV + ["--reselect-every", "2", "--corrupt", "scale+nan_burst",
                     "--corrupt-frac", "0.25", "--quarantine-limit", "2",
                     "--robust-agg", "trimmed_mean", "--compress-int",
                     "topk:0.01+int8", "--compress-ext", "int8"]
ARMS = {"markov": MARKOV, "tail": TAIL, "composed": COMPOSED}
FIELD = re.compile(r"(loss|divergence|disc|resel|part|stale|corr|clip|rb|"
                   r"test acc) ([0-9./]+)")
COUNTED = ("resel", "part", "stale", "corr", "rb")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rounds(text):
    return [FIELD.findall(ln) for ln in text.splitlines()
            if ln.startswith("round")]


def jax_cli_runs(tmp_path_factory, engine: str) -> dict:
    """The JAX CLI's round lines and ``--log-json`` records on ``engine``,
    once per flag set."""
    from repro.launch import train as jtrain
    out = {}
    for name, flags in ARMS.items():
        log = tmp_path_factory.mktemp(f"jax_{name}") / "log.json"
        buf = io.StringIO()
        with mock.patch.object(sys, "argv", ["train"] + SMOKE + flags + [
                "--engine", engine, "--log-json", str(log)]), \
                contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            jtrain.main()
        out[name] = (rounds(buf.getvalue()), json.loads(log.read_text()))
    return out


def assert_matches(ref, ref_recs, flags, capsys, tmp_path):
    """The port's CLI on the smoke command plus ``flags`` against the JAX
    CLI's lines and records."""
    log = tmp_path / "log.json"
    capsys.readouterr()
    train.main(SMOKE + flags + ["--device", "cpu", "--log-json", str(log)])
    out = rounds(capsys.readouterr().out)
    assert len(ref) == len(out) == 3
    for r, o in zip(ref, out):
        assert [k for k, _ in r] == [k for k, _ in o]
        assert "part" in dict(r)
        for (key, rv), (_, ov) in zip(r, o):
            if key in COUNTED:
                assert rv == ov, (key, rv, ov)
            else:
                assert abs(float(rv) - float(ov)) <= 1e-4, (key, rv, ov)
    recs = json.loads(log.read_text())
    for r, o in zip(ref_recs, recs, strict=True):
        for name in ("bytes_int", "bytes_ext", "reselections",
                     "dark_selected"):
            assert r[name] == o[name], (name, r[name], o[name])
        for name in ("participation", "staleness_mean", "staleness_max"):
            if r[name] is None:
                assert o[name] is None
            else:
                assert abs(r[name] - o[name]) <= 1e-6, (name, r, o)
    return recs


@pytest.fixture(scope="module")
def jax_host(tmp_path_factory):
    return jax_cli_runs(tmp_path_factory, "host")


@pytest.mark.parametrize("arm", list(ARMS))
def test_avail_cli_matches_reference(arm, jax_host, capsys, tmp_path):
    recs = assert_matches(*jax_host[arm], ARMS[arm], capsys, tmp_path)
    if arm == "composed":
        assert sum(rec["corrupted_selected"] for rec in recs) > 0
        assert all(rec["compress_error"] is not None for rec in recs)
    if arm != "markov":     # members that missed an iteration were seated
        assert sum(rec["dark_selected"] for rec in recs) > 0


def test_avail_flags_parse_and_warn(capsys):
    """The JAX CLI's defaults; ``bounded_async`` without a schedule is
    refused as the JAX package refuses it; a baseline strategy warns that
    ``--avail`` and ``--sync`` are FedGS-only."""
    args = train.build_parser().parse_args([])
    assert (args.avail, args.avail_up_prob, args.avail_dwell,
            args.avail_straggler_frac, args.avail_slow_factor,
            args.avail_deadline, args.sync, args.gamma, args.max_staleness,
            args.avail_selection) == ("always", 0.9, 8, 0.15, 4.0, 3.0,
                                      "sync", 0.5, 4, "aware")
    assert train.avail_fn_of(args) is None
    for bad in (["--avail", "flaky"], ["--sync", "async"],
                ["--avail-selection", "oracle"]):
        with pytest.raises(SystemExit):
            train.build_parser().parse_args(bad)
    small = ["--device", "cpu", "--groups", "2", "--devices-per-group", "4",
             "--selected", "2", "--presampled", "1", "--iters", "1",
             "--rounds", "1", "--batch-size", "2", "--smoke-model",
             "--local-steps", "1", "--eval-every", "5"]
    with pytest.raises(ValueError, match="availability schedule"):
        train.main(small + ["--sync", "bounded_async"])
    capsys.readouterr()
    train.main(small + ["--strategy", "fedavg", "--avail", "markov",
                        "--sync", "bounded_async"])
    err = capsys.readouterr().err
    assert "--avail applies only to --strategy fedgs" in err
    assert "--sync applies only to --strategy fedgs" in err
