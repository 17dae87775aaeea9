"""The ported CLI over the lazy population (DESIGN.md §17) against the JAX
CLI, in-process, on the smoke command with ``--devices 1000
--reselect-every 2`` (250 devices a factory, committees of 8 redrawn every
2 iterations): the round lines to 1e-4 with ``resel`` equal, and
``--log-json``'s selection telemetry, on the host loop, the fused engine
and for ``--strategy fedavg`` on both engines. The JAX CLI prints the same
FEDGS lines on ``--engine host`` and ``--engine fused`` for these flags
(both read its device stream over the population), so one JAX run serves
both port engines; fedavg is held engine against engine (the JAX
package's fused baselines keep a byte ledger, its host loop none). Then
the fused round against the port's host loop over the same candidate
sampler, through the library.
``tests/test_torch_population_compose_cli.py`` holds the compositions
with the availability, robust and drift flags."""
import contextlib
import io
import json
import re
import sys
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from repro.configs import femnist_cnn as jcfg
from repro.models import cnn as jcnn
from repro_torch import convert, tree
from repro_torch.core import fedgs
from repro_torch.data import (AvailabilityConfig, CorruptionConfig,
                              DeviceBackedStreams, DriftConfig,
                              LazyPopulation, PopulationConfig,
                              make_availability_fn, make_corruption_fn,
                              make_device_sampler)
from repro_torch.launch import train
from repro_torch.models import cnn
from test_torch_train import SMOKE

POP = ["--devices", "1000", "--reselect-every", "2"]
FEDAVG = ["--strategy", "fedavg"]
ARMS = {"fedgs": POP, "fedavg-host": POP + FEDAVG + ["--engine", "host"],
        "fedavg-fused": POP + FEDAVG + ["--engine", "fused"]}
FIELD = re.compile(r"(loss|divergence|disc|resel|part|stale|corr|clip|rb|"
                   r"test acc) ([0-9./]+)")
COUNTED = ("resel", "part", "stale", "corr", "rb")
TELEMETRY = ("group_discrepancy", "divergence", "selection_distance",
             "participation", "staleness_mean")
CFG = dict(num_groups=4, devices_per_group=8, num_selected=4,
           num_presampled=1, iters_per_round=5, rounds=3, lr=0.05,
           gbp_max_iters=16)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rounds(text):
    return [FIELD.findall(ln) for ln in text.splitlines()
            if ln.startswith("round")]


def jax_cli_runs(tmp_path_factory, arms: dict) -> dict:
    """The JAX CLI's round lines and ``--log-json`` records on the host
    engine, once per flag set."""
    from repro.launch import train as jtrain
    out = {}
    for name, flags in arms.items():
        log = tmp_path_factory.mktemp(f"jax_{name}") / "log.json"
        buf = io.StringIO()
        with mock.patch.object(sys, "argv", ["train"] + SMOKE + flags + [
                "--log-json", str(log)]), \
                contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            jtrain.main()
        out[name] = (rounds(buf.getvalue()), json.loads(log.read_text()))
    return out


def assert_matches(ref, ref_recs, flags, capsys, tmp_path):
    """The port's CLI on the smoke command plus ``flags`` against the JAX
    CLI's lines (numbers to 1e-4, the counted fields equal) and records
    (the rebuilds, dark and corrupted members and the byte ledger equal,
    the selection and availability telemetry to 1e-4). Returns the port's
    records."""
    log = tmp_path / "log.json"
    capsys.readouterr()
    train.main(SMOKE + flags + ["--device", "cpu", "--log-json", str(log)])
    out = rounds(capsys.readouterr().out)
    assert len(ref) == len(out) == 3
    for r, o in zip(ref, out):
        assert [k for k, _ in r] == [k for k, _ in o]
        for (key, rv), (_, ov) in zip(r, o):
            if key in COUNTED:
                assert rv == ov, (key, rv, ov)
            else:
                assert abs(float(rv) - float(ov)) <= 1e-4, (key, rv, ov)
    recs = json.loads(log.read_text())
    for r, o in zip(ref_recs, recs, strict=True):
        for name in ("reselections", "dark_selected", "corrupted_selected",
                     "rollbacks", "bytes_int", "bytes_ext"):
            assert r[name] == o[name], (name, r[name], o[name])
        for name in TELEMETRY:
            if r[name] is None:
                assert o[name] is None
            else:
                assert abs(r[name] - o[name]) <= 1e-4, (name, r, o)
    return recs


@pytest.fixture(scope="module")
def jax_cli(tmp_path_factory):
    return jax_cli_runs(tmp_path_factory, ARMS)


@pytest.mark.parametrize("arm,engine", [
    ("fedgs", "host"), ("fedgs", "fused"), ("fedavg-host", "host"),
    ("fedavg-fused", "fused")])
def test_population_cli_matches_reference(arm, engine, jax_cli, capsys,
                                          tmp_path):
    recs = assert_matches(*jax_cli[arm], ARMS[arm] + ["--engine", engine],
                          capsys, tmp_path)
    if arm == "fedgs":
        # cadence 2 over T = 5: the rebuilds 3, 2, 3 (the committee is
        # redrawn with each rebuild)
        assert [rec["reselections"] for rec in recs] == [3.0, 2.0, 3.0]


@pytest.fixture(scope="module")
def model():
    jparams = jcnn.init_cnn(jax.random.PRNGKey(0), jcfg.smoke_config())
    return convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")


@pytest.mark.parametrize("composed", [False, True],
                         ids=["drift", "avail-robust"])
def test_fused_matches_host_loop_under_candidates(composed, model):
    """The fused round (each iteration's seats staged with the round's
    keys) and the port's host loop over ``DeviceBackedStreams`` of the
    same candidate sampler (committees of 8 from 100 devices a factory,
    redrawn every 2 iterations) take the same steps: under a redraw drift,
    params bit-equal; under markov availability with blind selection,
    ``bounded_async`` and the robust layer with quarantine, params to 1e-5
    and the dark and corrupted members and rebuilds equal. Both hash their
    schedules on the seated population ids."""
    pop = LazyPopulation(PopulationConfig(num_factories=4,
                                          devices_per_factory=100,
                                          batch_size=8), device="cpu")
    drift = None if composed else DriftConfig(schedule="redraw", period=3)
    sampler = make_device_sampler(pop, drift=drift, candidates=8,
                                  candidate_every=2)
    extra = dict(sync="bounded_async", avail_selection="blind",
                 robust_agg="trimmed_mean", quarantine_limit=1,
                 robust_clip=0.5) if composed else {}
    cfg = fedgs.FedGSConfig(**CFG, reselect_every=2, **extra)
    kw = dict(group_loss_fn=cnn.make_group_loss_fn())
    if composed:
        kw.update(avail_fn=make_availability_fn(AvailabilityConfig(
            schedule="markov", up_prob=0.6, dwell=2), 0),
            corrupt_fn=make_corruption_fn(CorruptionConfig(
                mode="scale", frac=0.4, prob=0.8), 0))
    fused, flogs = fedgs.run_fedgs_fused(model, sampler, pop.p_real, cfg,
                                         **kw)
    host, hlogs = fedgs.run_fedgs(model, DeviceBackedStreams(sampler),
                                  pop.p_real, cfg, **kw)
    diff = max(float((a - b).abs().max()) for a, b in
               zip(tree.leaves(fused), tree.leaves(host), strict=True))
    assert diff <= (1e-5 if composed else 0.0)
    for f, h in zip(flogs, hlogs, strict=True):
        assert f.reselections == h.reselections
        for name in ("loss", "divergence", "group_discrepancy",
                     "selection_distance"):
            assert getattr(f, name) == pytest.approx(getattr(h, name),
                                                     abs=1e-5), name
        if composed:
            assert f.dark_selected == h.dark_selected
            assert f.corrupted_selected == h.corrupted_selected
    if composed:
        assert sum(f.dark_selected for f in flogs) > 0
        assert sum(f.corrupted_selected for f in flogs) > 0
