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
FIELD = re.compile(r"(loss|divergence|disc|resel|test acc) ([0-9.]+)")


def _rounds(text):
    lines = [ln for ln in text.splitlines() if ln.startswith("round")]
    return [FIELD.findall(ln) for ln in lines]


def test_cli_matches_reference(capsys, monkeypatch, tmp_path):
    monkeypatch.setattr(sys, "argv", ["train"] + SMOKE)
    jtrain.main()
    ref = _rounds(capsys.readouterr().out)
    log = tmp_path / "log.json"
    train.main(SMOKE + ["--device", "cpu", "--log-json", str(log)])
    out = _rounds(capsys.readouterr().out)
    assert len(ref) == len(out) == 3
    for r, o in zip(ref, out):
        assert [k for k, _ in r] == [k for k, _ in o]
        for (key, rv), (_, ov) in zip(r, o):
            if key == "resel":
                assert rv == ov
            else:
                assert abs(float(rv) - float(ov)) <= 1e-4, (key, rv, ov)
    recs = json.loads(log.read_text())
    assert [rec["round"] for rec in recs] == [0, 1, 2]
    assert recs[1]["test_accuracy"] is not None
    assert recs[0]["bytes_int"] > 0 and recs[0]["participation"] is None


def test_round_record_fields_match_reference():
    assert engine.RoundRecord._fields == jengine.RoundRecord._fields
    rec = engine.RoundRecord(round=0, loss=1.0)
    assert rec.to_dict()["divergence"] is None


def test_config_validation():
    with pytest.raises(ValueError):
        fedgs.FedGSConfig(selection="fedavg")
    with pytest.raises(ValueError):
        fedgs.FedGSConfig(init="random")
    assert fedgs.FedGSConfig(num_selected=10, num_presampled=2).l_sel == 8
