"""The device-resident engine of the port (``--engine fused``) against the
JAX package's, on ``test_fedgs_fused.py``'s small config (M=4, K=8, L=4,
L_rnd=1, T=5, R=3, n=8, the smoke CNN), on the CPU: the device stream's
counts and labels exactly and its images to ``IMG_TOL``, the selections of
every iteration exactly, ``run_fedgs_fused`` against JAX's, against the
port's own host loop over ``DeviceBackedStreams``, chunk 1 against chunk R,
the robust branch (DESIGN.md §15) against the host loop, the CLI against
the JAX CLI, and the branches the port refuses."""
import contextlib
import io
import json
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import femnist_cnn as jcfg
from repro.core import engine as jengine
from repro.core import selection as jselection
from repro.data import DeviceStream as JDeviceStream
from repro.data import make_device_sampler as jmake_device_sampler
from repro.models import cnn as jcnn
from repro_torch import convert, tree
from repro_torch.core import engine, fedgs, prng, selection
from repro_torch.data import (CorruptionConfig, DeviceBackedStreams,
                              DeviceStream, PartitionConfig, femnist,
                              make_corruption_fn, make_device_sampler,
                              make_partition, streaming)
from repro_torch.kernels import int8_quant
from repro_torch.launch import train
from repro_torch.models import cnn
from test_torch_train import SMOKE, _rounds

CFG = dict(num_groups=4, devices_per_group=8, num_selected=4,
           num_presampled=1, iters_per_round=5, rounds=3, lr=0.05,
           gbp_max_iters=16)
COMPRESS = dict(compress_int="topk:0.01+int8", compress_ext="int8")
COMPRESS_FLAGS = ["--compress-int", "topk:0.01+int8", "--compress-ext",
                  "int8"]
ROBUST_FLAGS = ["--corrupt", "scale+nan_burst+gauss_noise", "--corrupt-frac",
                "0.25", "--quarantine-limit", "2", "--robust-agg",
                "trimmed_mean"]
# the smoke command's config (SMOKE, test_torch_train.py): GBP-CS at its
# default cap of 64 steps
CLI_CFG = dict(CFG, gbp_max_iters=64)
# Images: the jitter's normal draws agree with jax.random.normal to 5e-7,
# and cos/sin to an ulp; through the affine map (coordinates up to ~20 px
# from the centre, prototype slopes below 1 per px) and the noise term
# (sigma <= 0.3) that moves a pixel by a few 1e-6 at most (measured 2.0e-6
# over 1.6 M pixels): 20 x normal's 5e-7.
IMG_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    part = make_partition(PartitionConfig(num_factories=4,
                                          devices_per_factory=8, seed=0))
    jsampler = jmake_device_sampler(
        JDeviceStream.from_partition(part, batch_size=8, seed=0))
    sampler = make_device_sampler(
        DeviceStream.from_partition(part, batch_size=8, seed=0, device="cpu"))
    jparams = jcnn.init_cnn(jax.random.PRNGKey(0), jcfg.smoke_config())
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return part, jsampler, sampler, jparams, params


@pytest.fixture(scope="module")
def jax_cli(tmp_path_factory):
    """The JAX CLI's ``--engine fused`` run on the smoke command, once per
    arm (plain, compressed, robust): its round lines, its ``--log-json``
    records and its final params (``--ckpt-dir``), reused by the engine
    and CLI tests. Its per-round and chunked read-backs print the same lines, so
    the port's ``--eval-chunk 3`` is held to the per-round run."""
    from repro import checkpoint as jckpt
    from repro.launch import train as jtrain
    out = {}
    for name, flags in (("plain", []), ("compress", COMPRESS_FLAGS),
                        ("robust", ROBUST_FLAGS)):
        tmp = tmp_path_factory.mktemp(f"jax_{name}")
        argv = ["train"] + SMOKE + ["--engine", "fused", "--log-json",
                                    str(tmp / "log.json"), "--ckpt-dir",
                                    str(tmp / "ckpt")] + flags
        buf = io.StringIO()
        with mock.patch.object(sys, "argv", argv), \
                contextlib.redirect_stdout(buf):
            jtrain.main()
        leaves, _ = jckpt.load(str(tmp / "ckpt" / "step_3"))
        out[name] = (_rounds(buf.getvalue()),
                     json.loads((tmp / "log.json").read_text()), leaves)
    return out


def _run(setup, graph=False, **extra):
    part, _, sampler, _, params = setup
    return fedgs.run_fedgs_fused(
        params, sampler, part.p_real, fedgs.FedGSConfig(**CFG, **extra),
        group_loss_fn=cnn.make_group_loss_fn(), graph=graph)


def _max_diff(ref_leaves, torch_tree):
    return max(float(np.abs(r - o.numpy()).max())
               for r, o in zip(ref_leaves, tree.leaves(torch_tree),
                               strict=True))


def _run_cli_config(setup, **extra):
    part, _, sampler, _, params = setup
    return fedgs.run_fedgs_fused(
        params, sampler, part.p_real, fedgs.FedGSConfig(**CLI_CFG, **extra),
        group_loss_fn=cnn.make_group_loss_fn())


# ------------------------------------------------------------ the stream

def test_xla_cumsum_matches_jnp_cumsum():
    p = np.random.default_rng(3).dirichlet(np.full(62, 0.3), size=(10, 35))
    p = p.astype(np.float32)
    np.testing.assert_array_equal(
        streaming.xla_cumsum(p),
        np.asarray(jax.jit(lambda q: jnp.cumsum(q, axis=-1))(p)))


def test_key_tensor_forms_match_numpy_keys():
    keys = prng.split(prng.PRNGKey(5), 3)
    kt = torch.as_tensor(keys.astype(np.int64))
    np.testing.assert_array_equal(
        prng.random_bits_t(kt, (4, 7)).numpy(),
        prng.random_bits_t(keys, (4, 7), "cpu").numpy())
    np.testing.assert_array_equal(prng.uniform_t(kt, (9,)).numpy(),
                                  prng.uniform_t(keys, (9,), "cpu").numpy())
    np.testing.assert_array_equal(prng.normal_t(kt, (9,)).numpy(),
                                  prng.normal_t(keys, (9,), "cpu").numpy())
    np.testing.assert_array_equal(prng.split_t(kt, 4).numpy(),
                                  prng.split(keys, 4).astype(np.int64))
    x = torch.randn(3, 64, generator=torch.Generator().manual_seed(0))
    assert torch.equal(int8_quant.quantize(x, kt),
                       int8_quant.quantize(x, keys))


def test_device_sampler_matches_reference(setup):
    """Counts and labels exact, images to IMG_TOL, at every iteration of
    the run, with an uneven mask (seats in index order)."""
    _, jsampler, sampler, _, _ = setup
    gids = torch.arange(4)
    jcounts = jax.jit(jsampler.counts)
    jbatch = jax.jit(jsampler.selected_batch, static_argnums=3)
    mask = np.zeros((4, 8), np.float32)
    mask[:, [6, 1, 3, 4]] = 1.0
    mask[2] = np.roll(mask[2], 1)
    worst = 0.0
    for t in range(CFG["iters_per_round"] * CFG["rounds"]):
        keys = torch.as_tensor(sampler.keys(t, np.arange(4)).astype(np.int64))
        labels = sampler.labels(keys, gids)
        np.testing.assert_array_equal(
            sampler.counts(labels).numpy(),
            np.asarray(jcounts(jnp.int32(t), jnp.arange(4))))
        imgs, labs = sampler.selected_batch(labels, keys, gids,
                                            torch.from_numpy(mask), 4)
        jimgs, jlabs = jbatch(jnp.int32(t), jnp.arange(4),
                              jnp.asarray(mask), 4)
        np.testing.assert_array_equal(labs.numpy(), np.asarray(jlabs))
        assert imgs.shape == (4, 4, 8, 28, 28)
        worst = max(worst, float(np.abs(imgs.numpy()
                                        - np.asarray(jimgs)).max()))
    assert worst <= IMG_TOL


def test_selections_match_reference(setup):
    """Every iteration's masks and GBP-CS trip counts from the staged keys
    (``RoundKeys``) equal JAX's from its key chain: selection depends on
    the counts and keys alone, not on the model."""
    part, jsampler, sampler, _, _ = setup
    cfg = fedgs.FedGSConfig(**CFG)
    layout = fedgs.RoundKeys(cfg, sampler)
    p_real = torch.as_tensor(part.p_real)
    jselect = jax.jit(lambda keys, counts: jselection.select_for_groups(
        keys, counts, part.p_real, 4, 1, max_iters=16))
    jcounts = jax.jit(jsampler.counts)
    key, jkey = prng.PRNGKey(0), jax.random.PRNGKey(0)
    for r in range(CFG["rounds"]):
        key, flat = layout.host(key, r * 5)
        views = layout.views(torch.as_tensor(flat))
        for i in range(5):
            t = r * 5 + i
            jkey, sub = jax.random.split(jkey)
            jres = jselect(jax.random.split(sub, 4),
                           jcounts(jnp.int32(t), jnp.arange(4)))
            counts = sampler.counts(sampler.labels(views["data"][i],
                                                   torch.arange(4)))
            res = selection.select_presampled(
                views["perm"][i], views["opt"][i], counts, p_real, 4, 1,
                max_iters=16)
            np.testing.assert_array_equal(res.mask.numpy(),
                                          np.asarray(jres.mask))
            np.testing.assert_array_equal(res.iterations.numpy(),
                                          np.asarray(jres.iterations))
    np.testing.assert_array_equal(key, np.asarray(jkey))


# ------------------------------------------------------------ the engine

def test_fused_matches_reference(setup, jax_cli):
    """``run_fedgs_fused`` against the JAX package's (as its CLI runs it):
    params and per-round loss and divergence to 1e-5, the selection
    telemetry and the byte ledger."""
    _, jrecs, jleaves = jax_cli["plain"]
    params, logs = _run_cli_config(setup)
    assert _max_diff(jleaves, params) <= 1e-5
    for r, o in zip(jrecs, logs, strict=True):
        assert o.loss == pytest.approx(r["loss"], abs=1e-5)
        assert o.divergence == pytest.approx(r["divergence"], abs=1e-5)
        assert o.selection_distance == pytest.approx(
            r["selection_distance"], abs=1e-5)
        assert o.group_discrepancy == pytest.approx(r["group_discrepancy"],
                                                    abs=1e-6)
        assert (o.reselections, o.bytes_int, o.bytes_ext) == \
            (r["reselections"], r["bytes_int"], r["bytes_ext"])


def test_fused_compress_matches_reference(setup, jax_cli):
    """§18 compression on both links, EF residuals in the carry: loss and
    divergence to 1e-5, the byte ledger exact, compress_error to 1e-5 in
    round 0 and 1e-2 after (last-bit gradient differences flip stochastic
    int8 roundings, CHANGES.md, PR 13). Those flips move a coordinate by
    one int8 quantum of its row (~max|g|/127·lr), so the params are held
    to 1e-3 (measured 5.2e-4), not 1e-5."""
    _, jrecs, jleaves = jax_cli["compress"]
    params, logs = _run_cli_config(setup, **COMPRESS)
    assert _max_diff(jleaves, params) <= 1e-3
    for r, o in zip(jrecs, logs, strict=True):
        assert o.loss == pytest.approx(r["loss"], abs=1e-5)
        assert o.divergence == pytest.approx(r["divergence"], abs=1e-5)
        assert (o.reselections, o.bytes_int, o.bytes_ext) == \
            (r["reselections"], r["bytes_int"], r["bytes_ext"])
        rel = 1e-5 if r["round"] == 0 else 1e-2
        assert o.compress_error == pytest.approx(r["compress_error"],
                                                 rel=rel)


def test_fused_matches_host_loop(setup):
    """The fused round and the port's host loop over the same device stream
    take the same steps: params bit-equal, records to f32 rounding (the
    fused round reduces its metrics in f32, the host loop in f64)."""
    part, _, sampler, _, params = setup
    fused, flogs = _run(setup)
    cfg = fedgs.FedGSConfig(**CFG)
    host, hlogs = fedgs.run_fedgs(params, DeviceBackedStreams(sampler),
                                  part.p_real, cfg,
                                  group_loss_fn=cnn.make_group_loss_fn())
    for a, b in zip(tree.leaves(fused), tree.leaves(host), strict=True):
        assert torch.equal(a, b)
    for f, h in zip(flogs, hlogs, strict=True):
        assert f.loss == pytest.approx(h.loss, abs=1e-6)
        assert f.divergence == pytest.approx(h.divergence, abs=1e-6)
        assert (f.reselections, f.bytes_int, f.bytes_ext) == \
            (h.reselections, h.bytes_int, h.bytes_ext)


@pytest.mark.parametrize("mode,method", [
    ("scale", "clip_norm"), ("nan_burst", "trimmed_mean"),
    ("sign_flip+gauss_noise", "coord_median"), ("inf_spike", "mean")])
def test_fused_robust_matches_host_loop(setup, mode, method, monkeypatch):
    """The robust branch of the fused round (DESIGN.md §15: staged fault
    trace, per-member step, NaN guard, quarantine in the carry) against
    the port's robust host loop over the same device stream, for the JAX
    package's four (mode, aggregator) pairs: params to 1e-5, ``corr`` and
    ``rb`` equal, ``clip`` and the residual to 1e-4, and the quarantine
    counters equal at every iteration (each one read as selection reads
    it), so after each round too."""
    part, _, sampler, _, params = setup
    cfg = fedgs.FedGSConfig(**dict(CFG, rounds=2), robust_agg=method,
                            robust_clip=5.0, quarantine_limit=2)
    cfn = make_corruption_fn(CorruptionConfig(mode=mode, frac=0.3, prob=0.6),
                             0)
    seen, quarantine_mask = [], selection.quarantine_mask
    monkeypatch.setattr(selection, "quarantine_mask", lambda q, limit: (
        seen.append(q.clone()), quarantine_mask(q, limit))[1])
    fused, flogs = fedgs.run_fedgs_fused(
        params, sampler, part.p_real, cfg,
        group_loss_fn=cnn.make_group_loss_fn(), corrupt_fn=cfn)
    fused_q = list(seen)
    seen.clear()
    host, hlogs = fedgs.run_fedgs(params, DeviceBackedStreams(sampler),
                                  part.p_real, cfg,
                                  group_loss_fn=cnn.make_group_loss_fn(),
                                  corrupt_fn=cfn)
    diff = max(float((a - b).abs().max()) for a, b in
               zip(tree.leaves(fused), tree.leaves(host), strict=True))
    assert diff <= 1e-5
    for f, h in zip(flogs, hlogs, strict=True):
        assert f.loss == pytest.approx(h.loss, abs=1e-5)
        assert (f.corrupted_selected, f.rollbacks) == \
            (h.corrupted_selected, h.rollbacks)
        assert f.clipped_fraction == pytest.approx(h.clipped_fraction,
                                                   abs=1e-4)
        assert f.agg_residual == pytest.approx(h.agg_residual, abs=1e-4)
        assert f.bytes_int == h.bytes_int
    assert sum(f.corrupted_selected for f in flogs) > 0
    assert len(fused_q) == len(seen) == 2 * CFG["iters_per_round"]
    assert all(torch.equal(a, b) for a, b in zip(fused_q, seen))
    assert int(seen[-1].sum()) > 0


def test_chunk_one_equals_chunk_r(setup):
    """Reading the metrics back per round or once per run changes nothing:
    the same records, eval (on the device, every 2nd round) included."""
    part, _, sampler, _, params = setup
    tx, ty = femnist.make_test_set(n_per_class=2)
    eval_fn = cnn.make_eval_fn(tx, ty, "cpu")
    runs = [fedgs.run_fedgs_fused(
        params, sampler, part.p_real, fedgs.FedGSConfig(**CFG),
        group_loss_fn=cnn.make_group_loss_fn(), eval_fn=eval_fn,
        eval_every=2, chunk=chunk)[1] for chunk in (1, CFG["rounds"])]
    assert [r.to_dict() for r in runs[0]] == [r.to_dict() for r in runs[1]]
    assert [r.test_accuracy is not None for r in runs[0]] == \
        [False, True, False]


def test_engine_helpers_match_reference():
    assert [engine.default_chunk(r, e) for r, e in ((10, 0), (3, 5), (9, 2))] \
        == [jengine.default_chunk(r, e) for r, e in ((10, 0), (3, 5), (9, 2))]
    assert engine.num_dispatches(7, 3) == jengine.num_dispatches(7, 3) == 3
    mets = {"loss": np.array([1.0, 2.0]),
            "test_accuracy": np.array([np.nan, 0.5]),
            "test_loss": np.array([np.nan, 0.25]),
            "bytes_int": np.array([3.0, 4.0])}
    assert [r.to_dict() for r in engine.records_from_metrics(
        2, mets, strategy="fedgs")] == [r.to_dict() for r in
                                        jengine.records_from_metrics(
                                            2, mets, strategy="fedgs")]


def test_unported_branches_raise(setup):
    part, _, sampler, _, params = setup
    run = lambda cfg=CFG, **kw: fedgs.run_fedgs_fused(
        params, sampler, part.p_real, fedgs.FedGSConfig(**cfg),
        group_loss_fn=cnn.make_group_loss_fn(), **kw)
    with pytest.raises(NotImplementedError, match="item 17"):
        run(mesh=object())
    with pytest.raises(ValueError, match="availability schedule"):
        run(dict(CFG, sync="bounded_async"))
    stream = DeviceStream.from_partition(part, batch_size=8, device="cpu")
    with pytest.raises(ValueError, match=r"candidates=9 must be in "
                       r"\[1, devices_per_factory=8\]"):
        make_device_sampler(stream, candidates=9)
    with pytest.raises(ValueError, match="card"):
        _run(setup, graph=True)


# ------------------------------------------------------------ the CLI

@pytest.mark.parametrize("port_flags,arm", [
    (["--eval-chunk", "1"], "plain"), (["--eval-chunk", "3"], "plain"),
    (COMPRESS_FLAGS, "compress"), (ROBUST_FLAGS, "robust"),
], ids=["chunk1", "chunk3", "compress", "robust"])
def test_fused_cli_matches_reference(port_flags, arm, jax_cli, capsys):
    """``--engine fused`` prints the JAX CLI's fused round lines to 1e-4
    (``resel``, and on the robust branch ``corr`` and ``rb``, equal),
    per-round and chunked read-back, compressed, and robust."""
    ref = jax_cli[arm][0]
    capsys.readouterr()
    recs = train.main(SMOKE + ["--engine", "fused", "--device", "cpu"]
                      + port_flags)
    out = _rounds(capsys.readouterr().out)
    assert len(ref) == len(out) == 3
    for r, o in zip(ref, out):
        assert [k for k, _ in r] == [k for k, _ in o]
        for (key, rv), (_, ov) in zip(r, o):
            if key in ("resel", "corr", "rb"):
                assert rv == ov
            else:
                assert abs(float(rv) - float(ov)) <= 1e-4, (key, rv, ov)
    assert recs[1]["test_accuracy"] is not None
    if arm == "robust":
        assert sum(r["corrupted_selected"] for r in recs) > 0


def test_cli_refuses_sharded_and_robust_fused():
    smoke = ["--device", "cpu", "--groups", "2", "--devices-per-group", "4",
             "--selected", "2", "--presampled", "1", "--iters", "1",
             "--rounds", "1", "--batch-size", "2", "--smoke-model"]
    with pytest.raises(NotImplementedError, match="item 17"):
        train.main(smoke + ["--engine", "sharded"])
