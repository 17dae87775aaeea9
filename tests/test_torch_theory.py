"""The §VI theory of the port against the JAX package: every function
``==`` on drawn floats, and the measured Prop. 4 crossover fed with both
CLIs' byte ledgers."""
import dataclasses
import json
import math
import sys

import pytest
import torch
from hypothesis_compat import given, settings, st

from repro.core import theory as jtheory
from repro.launch import train as jtrain
from repro_torch.core import theory
from repro_torch.launch import train

SMOKE = ["--groups", "4", "--devices-per-group", "8", "--selected", "4",
         "--presampled", "1", "--iters", "5", "--rounds", "3",
         "--batch-size", "8", "--smoke-model", "--lr", "0.05",
         "--eval-every", "2"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def same(name, *args, **kw):
    """``theory.name`` of both packages: equal results (``==``; dataclass
    reports field by field), or the same exception with the same
    message."""
    outs = []
    for mod in (theory, jtheory):
        try:
            outs.append(("ok", getattr(mod, name)(*args, **kw)))
        except (ValueError, AssertionError, OverflowError,
                ZeroDivisionError) as err:
            outs.append((type(err), str(err)))
    (tag, out), (ref_tag, ref) = outs
    assert tag == ref_tag, (name, outs)
    if dataclasses.is_dataclass(out):
        assert dataclasses.asdict(out) == dataclasses.asdict(ref)
        assert [f.name for f in dataclasses.fields(out)] == \
            [f.name for f in dataclasses.fields(ref)]
    else:
        assert out == ref and type(out) is type(ref), (name, out, ref)
    return tag, out


def nets(b_int, b_ext, snr, t_comp, t_select, size):
    kw = dict(model_size_bytes=size, b_int=b_int, b_ext=b_ext, snr=snr,
              t_comp=t_comp, t_select=t_select)
    return theory.NetworkModel(**kw), jtheory.NetworkModel(**kw)


def test_network_model_defaults_match_reference():
    net, ref = theory.NetworkModel(), jtheory.NetworkModel()
    assert dataclasses.asdict(net) == dataclasses.asdict(ref)
    assert net.beta_link == ref.beta_link
    assert net.t_select == 0.015       # the paper's GBP-CS latency


@settings(max_examples=60, deadline=None)
@given(T=st.integers(1, 400), R=st.integers(1, 1000),
       eta=st.floats(1e-4, 2.0), beta=st.floats(0.05, 10.0),
       rho=st.floats(0.0, 5.0), delta=st.floats(0.0, 2.0),
       varphi=st.floats(1e-3, 2.0), epsilon=st.floats(0.05, 3.0))
def test_bounds_match_reference(T, R, eta, beta, rho, delta, varphi,
                                 epsilon):
    """h, Prop. 3's bound (its ValueError where vacuous) and the relaxed
    gap bound (its assertion where η > 1/β)."""
    same("h", T, eta, beta)
    kw = dict(eta=eta, beta=beta, rho=rho, delta=delta, varphi=varphi)
    same("convergence_upper_bound", T, R, epsilon=epsilon, **kw)
    same("optimality_gap_bound", T, R, **kw)


def test_vacuous_bound_raises_as_reference():
    tag, msg = same("convergence_upper_bound", 8, 10, eta=10.0, beta=1.0,
                    rho=1.0, delta=1.0, varphi=0.01, epsilon=0.1)
    assert tag is ValueError and "vacuous" in msg
    tag, _ = same("optimality_gap_bound", 10, 10, eta=2.0, beta=1.0,
                  rho=1.0, delta=0.1, varphi=0.5)
    assert tag is AssertionError


@settings(max_examples=80, deadline=None)
@given(T=st.integers(1, 500), M=st.integers(1, 64), L=st.integers(1, 40),
       b_int=st.floats(1e6, 1e10), b_ext=st.floats(1e5, 1e9),
       snr=st.floats(0.1, 100.0), t_comp=st.floats(0.0, 1.0),
       t_select=st.floats(0.0, 0.5), size=st.floats(1e3, 1e9))
def test_time_model_matches_reference(T, M, L, b_int, b_ext, snr, t_comp,
                                      t_select, size):
    """Eqs. 24–25, Prop. 4 in both forms and the measured-bytes round time,
    L = 1 included."""
    net, ref = nets(b_int, b_ext, snr, t_comp, t_select, size)
    assert net.beta_link == ref.beta_link
    for name in ("t_fedgs_round", "t_fedavg_round", "efficiency_condition",
                 "efficiency_condition_exact"):
        out = getattr(theory, name)(T, M, L, net)
        assert out == getattr(jtheory, name)(T, M, L, ref)
        assert type(out) is type(getattr(jtheory, name)(T, M, L, ref))
    bi, be = 2.0 * size * L * T * M, 2.0 * size * M
    for select in (True, False):
        assert theory.t_round_measured(bi, be, T, M, net, select=select) \
            == jtheory.t_round_measured(bi, be, T, M, ref, select=select)


def test_l1_verdicts_match_reference():
    net, ref = theory.NetworkModel(), jtheory.NetworkModel()
    for T, M in [(1, 1), (50, 10), (500, 2)]:
        assert theory.efficiency_condition(T, M, 1, net) is False
        assert theory.efficiency_condition_exact(T, M, 1, net) is False
        assert jtheory.efficiency_condition(T, M, 1, ref) is False
    rep = theory.measured_crossover(
        bytes_int_g=1e6, bytes_ext_g=1e5, rounds_g=3, bytes_ext_a=1e5,
        rounds_a=3, T=5, M=4, L=1, net=net)
    assert rep.predicted_ratio == math.inf


@settings(max_examples=80, deadline=None)
@given(bi=st.floats(0.0, 1e11), be=st.floats(1.0, 1e10),
       rg=st.floats(1.0, 500.0), bea=st.floats(1.0, 1e11),
       ra=st.floats(1.0, 500.0), bia=st.floats(0.0, 1e9),
       T=st.integers(1, 100), M=st.integers(1, 32), L=st.integers(1, 20),
       t_select=st.floats(0.0, 0.1))
def test_measured_crossover_matches_reference(bi, be, rg, bea, ra, bia, T,
                                              M, L, t_select):
    """Every CrossoverReport field, the infinite ratios included."""
    net, ref = nets(1e9, 50e6, 10.0, 0.05, t_select, 26.4e6)
    kw = dict(bytes_int_g=bi, bytes_ext_g=be, rounds_g=rg, bytes_ext_a=bea,
              rounds_a=ra, T=T, M=M, L=L, bytes_int_a=bia)
    out = theory.measured_crossover(net=net, **kw)
    rep = jtheory.measured_crossover(net=ref, **kw)
    assert dataclasses.asdict(out) == dataclasses.asdict(rep)


def _ledgers(capsys, monkeypatch, tmp_path, flags):
    """The per-round records of the port CLI (``--device cpu``) and of the
    JAX CLI on the smoke command plus ``flags``, from ``--log-json``."""
    ref_log, log = tmp_path / "ref.json", tmp_path / "port.json"
    monkeypatch.setattr(sys, "argv", ["train"] + SMOKE + flags
                        + ["--log-json", str(ref_log)])
    jtrain.main()
    train.main(SMOKE + flags + ["--device", "cpu", "--log-json", str(log)])
    capsys.readouterr()
    return json.loads(log.read_text()), json.loads(ref_log.read_text())


def test_crossover_from_cli_byte_ledgers(capsys, monkeypatch, tmp_path):
    """Prop. 4 fed with the byte ledgers of a FEDGS and a fedavg run (the
    fused engine, which keeps the baselines' dense ``bytes_ext``): the
    port's bytes equal the JAX CLI's exactly, so the reports are equal."""
    g, g_ref = _ledgers(capsys, monkeypatch, tmp_path, [])
    a, a_ref = _ledgers(capsys, monkeypatch, tmp_path,
                        ["--strategy", "fedavg", "--engine", "fused",
                         "--local-steps", "2"])
    for recs, refs in ((g, g_ref), (a, a_ref)):
        assert [(r["bytes_int"], r["bytes_ext"]) for r in recs] == \
            [(r["bytes_int"], r["bytes_ext"]) for r in refs]
    assert g[0]["bytes_int"] > 0 and a[0]["bytes_ext"] > 0

    def report(mod, g, a):
        return mod.measured_crossover(
            bytes_int_g=g[0]["bytes_int"], bytes_ext_g=g[0]["bytes_ext"],
            rounds_g=len(g), bytes_ext_a=a[0]["bytes_ext"], rounds_a=len(a),
            bytes_int_a=a[0]["bytes_int"] or 0.0, T=5, M=4, L=4,
            net=mod.NetworkModel())

    out, ref = report(theory, g, a), report(jtheory, g_ref, a_ref)
    assert dataclasses.asdict(out) == dataclasses.asdict(ref)
    assert out.predicted_ratio == 5 * 4 / (4 * 3)
