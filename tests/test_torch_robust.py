"""The corruption-robust path (DESIGN.md §15) of the port against the JAX
package: fault injection, robust aggregation (plain and kernel wrapper),
outlier flags, quarantine, availability-aware selection, per-member
gradients, the robust train step and the CLI."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import femnist_cnn as jcfg
from repro.core import fedgs as jfedgs
from repro.core import selection as jselection
from repro.core import sync as jsync
from repro.data import partition as jpartition
from repro.data import streaming as jstreaming
from repro.kernels.robust_agg import ops as jrobust
from repro.models import cnn as jcnn
from repro_torch import convert, tree
from repro_torch.core import dispatch, fedgs, prng, selection, sync
from repro_torch.data import (CORRUPTION_MODES, CorruptionConfig,
                              make_corruption_fn)
from repro_torch.kernels import agg_weighted, corrupt, robust_agg
from repro_torch.models import cnn
from test_torch_train import assert_cli_matches


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these tests run thousands of small CPU ops, and
    under parallel test workers the default thread pool per worker
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPES = {"conv1": {"w": (5, 5, 1, 3), "b": (3,)},
          "fc2": {"w": (7, 5), "b": (5,)}}          # P = 75+3+35+5 = 118


def _stack(rng, lead):
    return {layer: {n: rng.normal(size=lead + s).astype(np.float32)
                    for n, s in v.items()} for layer, v in SHAPES.items()}


def _to_torch(trees):
    return tree.map(lambda a: torch.tensor(np.array(a)), trees)


def _assert_trees(out, ref, **tol):
    for layer in ref:
        for n in ref[layer]:
            np.testing.assert_allclose(
                out[layer][n].numpy(), np.asarray(ref[layer][n]), **tol)


# ----------------------------------------------------------------- faults

MIXES = list(CORRUPTION_MODES) + ["scale+nan_burst",
                                  "sign_flip+inf_spike+gauss_noise"]


@pytest.mark.parametrize("mode", MIXES)
def test_corruption_fn_matches_reference(mode):
    """Hit mask exact for every mode; corrupted grads bit-equal, except
    Gaussian noise (the port's normal agrees with jax.random.normal to
    5e-7)."""
    assert CORRUPTION_MODES == jstreaming.CORRUPTION_MODES
    kw = dict(mode=mode, frac=0.5, prob=0.6, t0=1, scale=7.0, sigma=0.5)
    ref_fn = jstreaming.make_corruption_fn(
        jstreaming.CorruptionConfig(**kw), 3, 400)
    out_fn = make_corruption_fn(CorruptionConfig(**kw), 3)
    rng = np.random.default_rng(0)
    ids = np.sort(rng.choice(400, 16, replace=False)).astype(np.int32)
    hits = 0.0
    for t in (0, 1, 4, 9):
        grads = _stack(rng, (16,))
        ref, ref_hit = ref_fn(jax.tree.map(jnp.asarray, grads), t,
                              jnp.asarray(ids))
        out, hit = out_fn(_to_torch(grads), t, torch.from_numpy(ids))
        np.testing.assert_array_equal(hit.numpy(), np.asarray(ref_hit))
        if t == 0:
            assert not hit.any()          # before t0 nothing fires
        hits += float(hit.sum())
        tol = dict(rtol=0, atol=1e-6) if "gauss_noise" in mode else \
            dict(rtol=0, atol=0)
        _assert_trees(out, ref, **tol)
    assert hits > 0


@pytest.mark.parametrize("mode", CORRUPTION_MODES)
def test_trace_and_corrupt_rows_match_reference(mode):
    """The host trace plus ``kernels.corrupt``'s plain version on the
    flattened member buffer against JAX's ``make_corruption_fn``: hit and
    NaN/Inf/scale/sign rows exact, Gaussian noise to 5e-7·σ (the port's
    normal against jax.random.normal), the P4 pad columns untouched."""
    sigma = 0.5
    kw = dict(mode=mode, frac=0.5, prob=0.7, scale=7.0, sigma=sigma)
    ref_fn = jstreaming.make_corruption_fn(
        jstreaming.CorruptionConfig(**kw), 5, 400)
    cfn = make_corruption_fn(CorruptionConfig(**kw), 5)
    rng = np.random.default_rng(11)
    ids = np.sort(rng.choice(400, 24, replace=False)).astype(np.int32)
    hits = 0
    for t in (0, 3, 8):
        grads = _stack(rng, (24,))
        ref, ref_hit = ref_fn(jax.tree.map(jnp.asarray, grads), t,
                              jnp.asarray(ids))
        tg = _to_torch(grads)
        sizes = [leaf[0].numel() for leaf in tree.leaves(tg)]
        code, keys = cfn.trace(t, ids, len(sizes))
        assert (keys is None) == (mode != "gauss_noise")
        np.testing.assert_array_equal((code > 0).astype(np.float32),
                                      np.asarray(ref_hit))
        hits += int((code > 0).sum())
        flat = agg_weighted.flatten(tg, 24)
        assert flat.shape[1] == 120 > sum(sizes)       # 2 pad columns
        out = corrupt.corrupt_rows_plain(
            flat, torch.from_numpy(code),
            None if keys is None else torch.from_numpy(keys.astype(np.int64)),
            sizes, cfn.modes, 7.0, sigma)
        assert out is flat and not flat[:, sum(sizes):].any()
        tol = 5e-7 * sigma if mode == "gauss_noise" else 0.0
        _assert_trees(agg_weighted.unflatten(flat, tg, 1), ref, rtol=0,
                      atol=tol)
    assert hits > 0


def test_corruption_config_validation():
    for bad in (dict(mode="bogus"), dict(frac=1.5), dict(prob=0.0),
                dict(t0=-1), dict(scale=0.0), dict(sigma=-1.0)):
        with pytest.raises(ValueError):
            jstreaming.CorruptionConfig(**bad)
        with pytest.raises(ValueError):
            CorruptionConfig(**bad)
    assert make_corruption_fn(None, 0) is None
    assert CorruptionConfig(mode="scale + sign_flip").modes == (
        "scale", "sign_flip")


# ------------------------------------------------------------ aggregation

def _robust_cases():
    """(M=3, K=5) member stacks: ties between rows, a zero-weight member
    and a member with one NaN; an all-zero-weight group (n = 0); a group
    whose members are all non-finite."""
    rng = np.random.default_rng(1)
    g = _stack(rng, (3, 5))
    for layer in g.values():
        for a in layer.values():
            a[0, 3] = a[0, 1]                      # exact tie between rows
            a[0, 2] *= 0.3                         # one member under clip
            a[2, :, ...] = np.inf                  # group 2: nothing finite
    g["fc2"]["w"][0, 4, 2, 1] = np.nan             # member 4: non-finite
    w = np.array([[1.0, 0.0, 2.0, 1.0, 1.0],
                  [0.0] * 5,
                  [1.0] * 5], np.float32)
    return g, w


@pytest.mark.parametrize("method", sync.ROBUST_AGGREGATORS)
@pytest.mark.parametrize("trim", [1, 2, 5])
def test_robust_aggregate_matches_reference(method, trim):
    """Plain ``sync.robust_aggregate`` against JAX's, and the kernel
    wrapper ``robust_agg.robust_aggregate_tree`` (CPU: its plain version)
    against JAX's Pallas kernel in interpret mode, per group, to 1e-6.
    ``mean`` is not fault-masked: NaN members propagate in both."""
    g, w = _robust_cases()
    kw = dict(clip=8.0, trim=trim)
    wrapped = robust_agg.robust_aggregate_tree(
        _to_torch(g), torch.from_numpy(w), method, **kw)
    fn = dispatch.robust_agg_fn(method, **kw)
    tg = _to_torch(g)
    flat = agg_weighted.flatten(tg, 15).view(3, 5, -1)
    routed = agg_weighted.unflatten(fn(flat, torch.from_numpy(w)), tg, 2)
    for m in range(3):
        gm = jax.tree.map(lambda a: jnp.asarray(a[m]), g)
        ref = jsync.robust_aggregate(gm, jnp.asarray(w[m]), method, **kw)
        ref_k = jrobust.robust_aggregate_tree(
            gm, jnp.asarray(w[m]), method=method, force_interpret=True, **kw)
        out = sync.robust_aggregate(
            _to_torch(jax.tree.map(np.asarray, gm)), torch.from_numpy(w[m]),
            method, **kw)
        tol = dict(rtol=1e-6, atol=1e-6)
        _assert_trees(out, ref, **tol)
        _assert_trees(tree.map(lambda a: a[m], wrapped), ref_k, **tol)
        _assert_trees(tree.map(lambda a: a[m], routed), ref_k, **tol)


def test_order_statistics_plain_matches_rank_reference():
    """The sort-based plain version of the kernel against the JAX
    package's rank-based Pallas kernel (interpret mode) on a wide stack:
    saturated trims, ties, inactive members, n = 0 and n = 1."""
    from repro.kernels.robust_agg import kernel as jkernel
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 6, 1024)).astype(np.float32)
    x[:, 4] = x[:, 1]
    x[:, 5, ::3] = x[:, 0, ::3]
    active = np.ones((4, 6), np.float32)
    active[1, ::2] = 0.0
    active[2] = 0.0
    active[3, 1:] = 0.0
    for method in robust_agg.METHODS:
        for trim in (0, 1, 2, 3, 9):
            out = robust_agg.aggregate(torch.from_numpy(x),
                                       torch.from_numpy(active), method, trim)
            for m in range(4):
                ref = jkernel.robust_agg_kernel(
                    jnp.asarray(x[m]), jnp.asarray(active[m]), method=method,
                    trim=trim, block_p=512, interpret=True)
                np.testing.assert_allclose(out[m].numpy(), np.asarray(ref),
                                           rtol=1e-6, atol=1e-6)


def test_member_flags_and_quarantine_match_reference():
    g, _ = _robust_cases()
    for m in range(3):
        gm = jax.tree.map(lambda a: a[m], g)
        tg, jg = _to_torch(gm), jax.tree.map(jnp.asarray, gm)
        np.testing.assert_array_equal(sync.member_finite(tg).numpy(),
                                      np.asarray(jsync.member_finite(jg)))
        np.testing.assert_allclose(sync.member_norms(tg).numpy(),
                                   np.asarray(jsync.member_norms(jg)),
                                   rtol=1e-6)
        for clip in (3.0, 8.0, 100.0):
            np.testing.assert_array_equal(
                sync.member_outlier_flags(tg, clip).numpy(),
                np.asarray(jsync.member_outlier_flags(jg, clip)))
    q = np.random.default_rng(3).integers(0, 5, (4, 8)).astype(np.int32)
    for limit in (0, 1, 2, 3, 7):
        np.testing.assert_array_equal(
            selection.quarantine_mask(torch.from_numpy(q), limit).numpy(),
            np.asarray(jselection.quarantine_mask(jnp.asarray(q), limit)))
    for bad in ("median", "trimmed"):
        with pytest.raises(ValueError):
            sync.check_robust_agg(bad)
    mask = np.zeros((4, 8), np.float32)
    mask[:, :3] = 1.0
    for ok, do in ((np.ones((4, 8), np.float32), False),
                   (selection.quarantine_mask(torch.from_numpy(q), 3).numpy(),
                    False), (np.ones((4, 8), np.float32), True)):
        for l in (3, 4):
            assert selection.reselect_trigger(
                do, torch.from_numpy(mask), torch.from_numpy(ok), l) == bool(
                jselection.reselect_trigger(jnp.asarray(do), jnp.asarray(mask),
                                            jnp.asarray(ok), l))


def test_where_groups_keeps_new_bits_and_rolls_back_bad_groups():
    rng = np.random.default_rng(4)
    new = _to_torch(_stack(rng, (3,)))
    old = _to_torch(_stack(rng, (3,)))
    new["fc2"]["b"][1, 0] = float("nan")
    ok = fedgs._group_finite(new)
    assert ok.tolist() == [True, False, True]
    out = fedgs._where_groups(ok, new, old)
    for layer in new:
        for n in new[layer]:
            assert torch.equal(out[layer][n][0], new[layer][n][0])
            assert torch.equal(out[layer][n][1], old[layer][n][1])


# -------------------------------------------------------------- selection

@pytest.mark.parametrize("method,init", [("gbp_cs", "mpinv"),
                                         ("gbp_cs", "random"),
                                         ("random", "mpinv")])
def test_select_for_groups_with_avail_matches_reference(method, init):
    """Quarantine reaches selection as ``avail``: zeroed counts, the stable
    up-first pre-sample partition, the repair step and mask·avail. One
    group keeps fewer eligible devices than L. Masks and iteration counts
    exact; ``init='random'`` draws key_opt's uniforms."""
    part = jpartition.make_partition(jpartition.PartitionConfig(
        num_factories=4, devices_per_factory=8, seed=5))
    streams = jstreaming.FactoryStreams(part, batch_size=8, seed=5)
    rng = np.random.default_rng(5)
    key, pkey = jax.random.PRNGKey(5), prng.PRNGKey(5)
    for it in range(3):
        key, sub = jax.random.split(key)
        pkey, psub = prng.split(pkey)
        counts = streams.next_counts()
        streams.fetch_selected(np.eye(4, 8, dtype=np.float32), 1)
        avail = (rng.uniform(size=(4, 8)) > 0.3).astype(np.float32)
        avail[3] = 0.0
        avail[3, [1, 6]] = 1.0                  # 2 eligible < L = 4
        if it == 0:
            avail[0] = 1.0                      # avail ≡ 1 is an identity
        ref = jselection.select_for_groups(
            jax.random.split(sub, 4), jnp.asarray(counts),
            jnp.asarray(part.p_real), 4, 1, avail=jnp.asarray(avail),
            method=method, init=init)
        out = selection.select_for_groups(
            prng.split(psub, 4), torch.from_numpy(counts),
            torch.from_numpy(part.p_real), 4, 1,
            avail=torch.from_numpy(avail), method=method, init=init)
        np.testing.assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))
        np.testing.assert_array_equal(out.iterations.numpy(),
                                      np.asarray(ref.iterations))
        np.testing.assert_allclose(out.distance.numpy(),
                                   np.asarray(ref.distance), rtol=1e-5)
        np.testing.assert_allclose(out.divergence.numpy(),
                                   np.asarray(ref.divergence), rtol=1e-5)
        assert float(out.mask[3].sum()) == 2.0
        single = selection.select_clients_via_gbp_cs(
            prng.split(psub, 4)[2], torch.from_numpy(counts[2]),
            torch.from_numpy(part.p_real), 4, 1,
            avail=torch.from_numpy(avail[2]), init=init)
        if method == "gbp_cs":
            assert torch.equal(single.mask, out.mask[2])


# ------------------------------------------------------------ train steps

def _cnn_batch(m, l, n, seed):
    p = jcnn.init_cnn(jax.random.PRNGKey(seed), jcfg.smoke_config())
    rng = np.random.default_rng(seed)
    gp = {layer: {k: (np.asarray(v)[None]
                      + rng.normal(0, 0.01, (m,) + v.shape)).astype(np.float32)
                  for k, v in lv.items()} for layer, lv in p.items()}
    x = rng.uniform(0, 1.5, (m, l, n, 28, 28)).astype(np.float32)
    y = rng.integers(0, 62, (m, l, n)).astype(np.int32)
    return gp, x, y


def test_unflatten_leaves_no_reference_cycle():
    """Dropping ``tree.unflatten``'s result frees the tensors at once, with
    no garbage collection: the robust step unflattens its member stacks
    (2.64 GB each at full width) every iteration."""
    import gc
    import weakref
    x = torch.zeros(3)
    alive = weakref.ref(x)
    gc.disable()
    try:
        out = tree.unflatten({"fc": {"w": 0, "b": 0}}, [torch.ones(2), x])
        assert out["fc"]["w"] is x
        del out, x
        assert alive() is None
    finally:
        gc.enable()


def test_member_grads_match_reference():
    """One backward at G = M·L gives each member's own gradient."""
    m, l, n = 2, 3, 4
    gp, x, y = _cnn_batch(m, l, n, 6)
    losses, grads = fedgs.member_grads(
        convert.params_from_jax(gp, "cpu"),
        (torch.from_numpy(x), torch.from_numpy(y)), cnn.make_group_loss_fn())
    for g in range(m):
        pm = jax.tree.map(lambda a: jnp.asarray(a[g]), gp)
        ref_l, ref_g = jax.vmap(lambda b: jsync.local_grads(
            pm, b, jcnn.loss_fn))((jnp.asarray(x[g]), jnp.asarray(y[g])))
        np.testing.assert_allclose(losses[g].numpy(), np.asarray(ref_l),
                                   rtol=1e-5, atol=1e-5)
        _assert_trees(tree.map(lambda a: a[g * l:(g + 1) * l], grads), ref_g,
                      rtol=1e-5, atol=1e-5)


def test_grad_avg_equals_model_avg():
    """For one SGD step from a common ω, averaging the L one-step models
    equals one step along the averaged gradient (Eq. 4, DESIGN.md §11)."""
    m, l, n = 2, 3, 4
    gp, x, y = _cnn_batch(m, l, n, 7)
    batches = (torch.from_numpy(x), torch.from_numpy(y))
    out = {}
    for step in ("grad_avg", "model_avg"):
        cfg = fedgs.FedGSConfig(num_groups=m, num_selected=l,
                                num_presampled=1, lr=0.05, train_step=step)
        out[step] = fedgs.make_group_train_step(
            cnn.make_group_loss_fn(), cfg)(convert.params_from_jax(gp, "cpu"),
                                           batches)
    np.testing.assert_allclose(out["grad_avg"][1].numpy(),
                               out["model_avg"][1].numpy(), rtol=1e-6)
    _assert_trees(out["model_avg"][0], tree.map(
        lambda a: a.numpy(), out["grad_avg"][0]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("method", ["trimmed_mean", "clip_norm"])
def test_robust_train_step_matches_reference(method):
    """The port's robust step (per-member backward, injection, robust
    Eq. 4, SGD) against JAX's jitted ``make_robust_train_step``, with one
    zero seat weight."""
    m, l, n = 2, 3, 4
    gp, x, y = _cnn_batch(m, l, n, 8)
    kw = dict(mode="scale+nan_burst+sign_flip", frac=0.6, prob=0.9,
              scale=30.0)
    fresh_w = np.array([[1.0, 1.0, 1.0], [1.0, 1.0, 0.0]], np.float32)
    dev_ids = np.array([[0, 2, 5], [9, 10, 13]], np.int32)
    common = dict(num_groups=m, devices_per_group=8, num_selected=l,
                  num_presampled=1, lr=0.05, robust_agg=method,
                  robust_clip=5.0)
    jcfg_ = jfedgs.FedGSConfig(**common)
    jstep = jfedgs.make_robust_train_step(
        jcnn.loss_fn, jcfg_, jstreaming.make_corruption_fn(
            jstreaming.CorruptionConfig(**kw), 1, 16))
    t = 2
    ref_p, ref_loss, _, ref_rs = jstep(
        jax.tree.map(jnp.asarray, gp), (jnp.asarray(x), jnp.asarray(y)),
        jnp.asarray(fresh_w), jnp.int32(t), jnp.asarray(dev_ids))
    cfg = fedgs.FedGSConfig(**common)
    cfn = make_corruption_fn(CorruptionConfig(**kw), 1)
    out_p, loss, rs = fedgs._train_robust(
        convert.params_from_jax(gp, "cpu"),
        (torch.from_numpy(x), torch.from_numpy(y)),
        torch.from_numpy(fresh_w),
        cfn.device_trace(t, dev_ids, len(jax.tree.leaves(gp)), "cpu"),
        cnn.make_group_loss_fn(), cfg, cfn,
        dispatch.robust_agg_fn(method, clip=5.0, trim=1))
    assert float(rs.hit.sum()) > 0
    np.testing.assert_array_equal(rs.hit.numpy(), np.asarray(ref_rs.hit))
    np.testing.assert_array_equal(rs.flags.numpy(), np.asarray(ref_rs.flags))
    np.testing.assert_allclose(rs.residual.numpy(),
                               np.asarray(ref_rs.residual), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss), rtol=1e-5)
    _assert_trees(out_p, ref_p, rtol=1e-5, atol=1e-5)


def test_robust_config_matches_reference_validation():
    fields = ("train_step", "robust_agg", "robust_clip", "robust_trim",
              "quarantine_limit", "nan_guard")
    jdef = {f.name: f.default for f in dataclasses.fields(jfedgs.FedGSConfig)}
    pdef = {f.name: f.default for f in dataclasses.fields(fedgs.FedGSConfig)}
    assert {f: pdef[f] for f in fields} == {f: jdef[f] for f in fields}
    assert sync.ROBUST_AGGREGATORS == jsync.ROBUST_AGGREGATORS
    assert "robust_agg" in dispatch.KERNELS


# -------------------------------------------------------------------- CLI

ROBUST = ["--corrupt", "scale+nan_burst", "--corrupt-frac", "0.25",
          "--quarantine-limit", "2"]


@pytest.mark.parametrize("agg", ["mean", "trimmed_mean"])
def test_robust_cli_matches_reference(agg, capsys, monkeypatch):
    """``mean`` rolls NaN-poisoned groups back (rb > 0); ``trimmed_mean``
    trims the faults out; both quarantine repeat offenders."""
    recs = assert_cli_matches(capsys, monkeypatch,
                              ROBUST + ["--robust-agg", agg])
    assert sum(r["corrupted_selected"] for r in recs) > 0
    rb = sum(r["rollbacks"] for r in recs)
    assert rb > 0 if agg == "mean" else rb == 0
