"""The slice as a whole: both CLIs, in-process, on the smoke command."""
import json
import re
import sys

import pytest

from repro.core import engine as jengine
from repro.launch import train as jtrain
from repro_torch.core import engine, fedgs
from repro_torch.launch import train

SMOKE = ["--groups", "4", "--devices-per-group", "8", "--selected", "4",
         "--presampled", "1", "--iters", "5", "--rounds", "3",
         "--batch-size", "8", "--smoke-model", "--lr", "0.05",
         "--eval-every", "2"]
FIELD = re.compile(
    r"(loss|divergence|disc|resel|corr|clip|rb|test acc) ([0-9.]+)")
COUNTED = ("resel", "corr", "rb")


def _rounds(text):
    lines = [ln for ln in text.splitlines() if ln.startswith("round")]
    return [FIELD.findall(ln) for ln in lines]


def assert_cli_matches(capsys, monkeypatch, flags, log=None, ref_log=None):
    """Both CLIs in-process on the smoke command plus ``flags``: the same
    round lines, numbers to 1e-4 and the counted fields equal. Returns the
    port's round records; ``log``/``ref_log`` take the port's/the JAX
    CLI's ``--log-json``."""
    monkeypatch.setattr(sys, "argv", ["train"] + SMOKE + flags + (
        ["--log-json", str(ref_log)] if ref_log else []))
    jtrain.main()
    ref = _rounds(capsys.readouterr().out)
    recs = train.main(SMOKE + flags + ["--device", "cpu"]
                      + (["--log-json", str(log)] if log else []))
    out = _rounds(capsys.readouterr().out)
    assert len(ref) == len(out) == 3
    for r, o in zip(ref, out):
        assert [k for k, _ in r] == [k for k, _ in o]
        for (key, rv), (_, ov) in zip(r, o):
            if key in COUNTED:
                assert rv == ov, (key, rv, ov)
            else:
                assert abs(float(rv) - float(ov)) <= 1e-4, (key, rv, ov)
    return recs


def test_cli_matches_reference(capsys, monkeypatch, tmp_path):
    log = tmp_path / "log.json"
    assert_cli_matches(capsys, monkeypatch, [], log)
    recs = json.loads(log.read_text())
    assert [rec["round"] for rec in recs] == [0, 1, 2]
    assert recs[1]["test_accuracy"] is not None
    assert recs[0]["bytes_int"] > 0 and recs[0]["participation"] is None
    assert recs[0]["rollbacks"] is None


@pytest.mark.parametrize("flags", [
    ["--train-step", "model_avg"],
    ["--selected", "5", "--corrupt", "sign_flip+inf_spike+gauss_noise",
     "--corrupt-frac", "0.25", "--quarantine-limit", "2", "--robust-agg",
     "coord_median"],
], ids=["model_avg", "coord_median"])
def test_scenario_cli_matches_reference(flags, capsys, monkeypatch):
    """The ``model_avg`` oracle prints the default path's lines; the
    coordinate median at L = 5 (where it differs from a trim-1 mean) under
    a three-mode fault mix, with quarantine."""
    recs = assert_cli_matches(capsys, monkeypatch, flags)
    if "--corrupt" in flags:
        assert sum(r["corrupted_selected"] for r in recs) > 0


def test_cli_rejects_flags_outside_the_port(capsys):
    """The lazy population's flags are refused as the JAX CLI refuses
    them: a ``--devices`` that does not divide over the groups, and fewer
    physical devices a factory than engine slots."""
    for flags, msg in (
            (["--devices", "1001", "--groups", "10"],
             "--devices must be divisible by --groups"),
            (["--population-per-group", "20", "--devices-per-group", "35"],
             "--population-per-group / --devices per factory must be >= "
             "--devices-per-group (the engine slots draw from it)"),
            (["--devices", "300", "--groups", "10"],
             "--population-per-group / --devices per factory must be >= "
             "--devices-per-group")):
        with pytest.raises(SystemExit):
            train.parse_args(flags)
        assert msg in capsys.readouterr().err
    assert train.parse_args(["--devices", "1000"]).k_pop == 100
    assert train.parse_args(["--population-per-group", "64"]).k_pop == 64
    assert train.parse_args([]).k_pop == 0


def test_round_record_fields_match_reference():
    assert engine.RoundRecord._fields == jengine.RoundRecord._fields
    rec = engine.RoundRecord(round=0, loss=1.0)
    assert rec.to_dict()["divergence"] is None


def test_config_validation():
    with pytest.raises(ValueError):
        fedgs.FedGSConfig(selection="fedavg")
    with pytest.raises(ValueError):
        fedgs.FedGSConfig(init="pinv")
    assert fedgs.FedGSConfig(init="random").init == "random"
    with pytest.raises(ValueError):
        fedgs.FedGSConfig(train_step="local")
    with pytest.raises(ValueError):
        fedgs.FedGSConfig(robust_agg="median")
    with pytest.raises(ValueError):
        fedgs.FedGSConfig(train_step="model_avg", robust_agg="trimmed_mean")
    for bad in (dict(robust_clip=0.0), dict(robust_trim=-1),
                dict(quarantine_limit=-1)):
        with pytest.raises(ValueError):
            fedgs.FedGSConfig(**bad)
    assert fedgs.FedGSConfig(num_selected=10, num_presampled=2).l_sel == 8
