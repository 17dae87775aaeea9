"""The §18 compressed-sync path (DESIGN.md §18) of the port against the JAX
package: the spec grammar and byte formulas, the top-k and int8 plain
versions of the port's two kernels, the EF event leaf for leaf, the host
loop's records and the CLI with its ``--log-json`` ledger."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import femnist_cnn as jcfg
from repro.core import compress as jcompress
from repro.core import fedgs as jfedgs
from repro.data import FactoryStreams as JFactoryStreams
from repro.data import PartitionConfig, make_partition
from repro.data import streaming as jstreaming
from repro.kernels.topk_compress import kernel as jtopk_kernel
from repro.models import cnn as jcnn
from repro_torch import convert
from repro_torch.core import compress, dispatch, fedgs
from repro_torch.data import (CorruptionConfig, FactoryStreams,
                              make_corruption_fn)
from repro_torch.kernels import agg_weighted, int8_quant, topk_compress
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


SPECS = ["none", "topk:0.01", "int8", "topk:0.5+int8", "int8+topk:0.5",
         " topk:1.0 ", "topk", "topk:", "topk:0", "topk:1.5", "topk:-0.1",
         "gzip", "int8+int8", "topk:0.1+topk:0.2", "topk:abc"]


def _parse_both(spec):
    """(port, JAX) parse of one spec; a ValueError is the outcome."""
    out = []
    for fn in (compress.parse_compress, jcompress.parse_compress):
        try:
            out.append(fn(spec))
        except ValueError:
            out.append(ValueError)
    return out


@pytest.mark.parametrize("spec", SPECS)
def test_parse_compress_matches_reference(spec):
    port, ref = _parse_both(spec)
    if ref is ValueError or ref is None:
        assert port is ref
    else:
        assert (port.topk_frac, port.int8) == (ref.topk_frac, ref.int8)


@pytest.mark.parametrize("n", [1, 7, 1000, 6_603_710])
def test_topk_count_and_payload_match_reference(n):
    for frac in (1e-9, 0.01, 0.1, 0.5, 1.0):
        assert compress.topk_count(n, frac) == jcompress.topk_count(n, frac)
    for spec in ("none", "topk:0.01", "int8", "topk:0.01+int8", "topk:1.0"):
        assert compress.payload_bytes(n, compress.parse_compress(spec)) == \
            jcompress.payload_bytes(n, jcompress.parse_compress(spec))
    assert compress.FOLD_COMPRESS == jcompress.FOLD_COMPRESS


# ------------------------------------------------------------------ top-k

def _rows(rng, m, p):
    """Gradient-like rows rounded to one decimal: ties abound."""
    return np.round(rng.normal(size=(m, p)) * 2, 1).astype(np.float32)


@pytest.mark.parametrize("p", [513, 200_003])
def test_topk_plain_matches_topk_select_dense(p):
    rng = np.random.default_rng(p)
    x = _rows(rng, 3, p)
    for k in (1, compress.topk_count(p, 0.01), p // 2, p - 1):
        out = topk_compress.select_plain(torch.from_numpy(x), k).numpy()
        for r in range(3):
            ref = np.asarray(jcompress.topk_select_dense(jnp.asarray(x[r]),
                                                         k))
            np.testing.assert_array_equal(out[r], ref)


@pytest.mark.parametrize("p", [512, 1024])
def test_topk_plain_matches_pallas_kernel(p):
    """The Pallas kernel itself, in interpret mode (pairwise ranks)."""
    rng = np.random.default_rng(p + 1)
    x = _rows(rng, 2, p)
    x[1, ::5] = 0.0
    for k in (1, 37, p // 2, p - 1):
        out = topk_compress.select_plain(torch.from_numpy(x), k).numpy()
        for r in range(2):
            ref = jtopk_kernel.topk_select_kernel(
                jnp.asarray(x[r]), k=k, block_p=256, interpret=True)
            np.testing.assert_array_equal(out[r], np.asarray(ref))


@pytest.mark.parametrize("k", [1, 5, 11])
def test_topk_ties_zeros_and_signed_zero(k):
    """Runs of exact ties across the vector, zeros and −0.0: the first k in
    (|x| descending, index ascending) order are kept, bit for bit (−0.0
    kept is −0.0, dropped is +0.0)."""
    x = np.array([0.5, -2.0, 2.0, -0.0, 0.0, 2.0, -0.5, 0.5, -0.0, 2.0,
                  -2.0, 0.0], np.float32)
    out = topk_compress.select_plain(torch.from_numpy(x[None]), k).numpy()[0]
    ref = np.asarray(jcompress.topk_select_dense(jnp.asarray(x), k))
    np.testing.assert_array_equal(out.view(np.uint32), ref.view(np.uint32))
    assert np.count_nonzero(np.signbit(out)) == np.count_nonzero(
        np.signbit(ref))


def test_topk_rows_never_keep_pads():
    """k from the true |θ| = n: the ≤ 3 zero pads sit at the highest
    indices and rank after every real coordinate, real zeros included. A
    row of n = 5 negative zeros, padded to 8: k = 4 keeps the first four
    (sign bit set), drops the fifth and the pads."""
    x = torch.full((2, 8), -0.0)
    x[:, 5:] = 0.0
    x[1, 2] = 3.0
    out = compress.topk_rows(x, 5, 4)
    np.testing.assert_array_equal(np.signbit(out[0].numpy()),
                                  [1, 1, 1, 1, 0, 0, 0, 0])
    np.testing.assert_array_equal(np.signbit(out[1].numpy()),
                                  [1, 1, 0, 1, 0, 0, 0, 0])
    assert float(out[1, 2]) == 3.0
    assert compress.topk_rows(x, 5, 5) is x        # k >= n keeps all
    assert not compress.topk_rows(x, 5, 0).any()
    with pytest.raises(ValueError):
        topk_compress.select(x, 9)


@pytest.mark.parametrize("p,blocks,cap", [
    (4, 1, 4), (1000, 1, 1000), (1025, 2, 1025), (40_000, 40, 4096),
    (100_004, 98, 6250), (6_603_712, 256, 412_732), (10 ** 9, 256,
                                                     62_500_000)])
def test_topk_chunks_and_candidate_buffer(p, blocks, cap):
    """Chunks of >= 1024 coordinates, at most 256 a row; a candidate buffer
    of 1/16 of the row (>= 4096, <= P); the scratch words per row: the row
    and chunk histograms, the chunks' offsets and tie counts, the
    candidates."""
    assert topk_compress.blocks_for(p) == blocks
    assert topk_compress.candidate_capacity(p) == cap
    for m in (1, 10):
        assert topk_compress.scratch_words(m, p) == m * (
            2048 + blocks * 2048 + blocks + 1 + blocks + cap)


def test_topk_select_with_stats_on_cpu_is_the_plain_version():
    x = torch.randn(3, 100)
    dispatch.reset_launch_counts()
    out, stats = topk_compress.select_with_stats(x, 7)
    assert stats is None and torch.equal(out, topk_compress.select_plain(x, 7))
    assert torch.equal(topk_compress.select(x, 7), out)
    assert dispatch.launch_counts()["topk_compress"] == 0
    assert topk_compress.STATS == ("tau_key", "ties_kept", "candidates",
                                   "route")


def test_topk_rows_equal_reference_on_padded_cnn_buffer():
    """A flattened, padded (M, P4) gradient buffer of the smoke CNN: each
    row's first n coordinates equal ``topk_select_dense`` at k from n,
    and the pads stay zero."""
    p = jcnn.init_cnn(jax.random.PRNGKey(0), jcfg.smoke_config())
    rng = np.random.default_rng(2)
    g = {lay: {k: np.round(rng.normal(size=(3,) + v.shape), 2)
               .astype(np.float32) for k, v in lv.items()}
         for lay, lv in p.items()}
    flat = agg_weighted.flatten(convert.params_from_jax(g, "cpu"), 3)
    n = sum(v.size for lv in p.values() for v in lv.values())
    assert flat.shape[1] - n in (1, 2, 3)
    k = compress.topk_count(n, 0.01)
    out = compress.topk_rows(flat, n, k).numpy()
    assert not out[:, n:].any()
    for r in range(3):
        ref = np.asarray(jcompress.topk_select_dense(
            jnp.asarray(flat[r, :n].numpy()), k))
        np.testing.assert_array_equal(out[r, :n], ref)


# ------------------------------------------------------------------- int8

@pytest.mark.parametrize("p", [1_000, 200_003])
def test_int8_plain_bit_equal_reference(p):
    """Each row under its own key, bit for bit what the JAX package's
    ``int8_quantize`` computes under ``jit`` (every JAX path runs it
    jitted: XLA multiplies by the float32 1/127 where eager JAX
    divides by 127); a row of zeros stays zeros, exact zeros stay zero."""
    rng = np.random.default_rng(p)
    x = (rng.normal(size=(4, p)) * [[1e-3], [1.0], [30.0], [0.0]]
         ).astype(np.float32)
    x[1, ::3] = 0.0
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(p), 4))
    out = int8_quant.quantize_plain(torch.from_numpy(x), keys).numpy()
    ref = np.asarray(jax.jit(jax.vmap(jcompress.int8_quantize))(
        jnp.asarray(x), jnp.asarray(keys)))
    np.testing.assert_array_equal(out.view(np.uint32), ref.view(np.uint32))
    assert not out[3].any() and not out[1, ::3].any()
    assert np.all(np.abs(out) <= np.abs(x).max(1, keepdims=True) * 1.0001)


def test_int8_plain_eager_reference_differs_only_in_scale():
    """Against eager JAX the only difference is the scale's last bit
    (true division by 127): every row whose two scales agree is equal."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(40, 257)).astype(np.float32)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(3), 40))
    out = int8_quant.quantize_plain(torch.from_numpy(x), keys).numpy()
    same = 0
    for r in range(40):
        mx = np.abs(x[r]).max()
        if np.float32(mx) / np.float32(127) != \
                np.float32(mx) * np.float32(int8_quant.INV_127):
            continue
        same += 1
        ref = np.asarray(jcompress.int8_quantize(jnp.asarray(x[r]),
                                                 jnp.asarray(keys[r])))
        np.testing.assert_array_equal(out[r], ref)
    assert same > 20


def test_int8_plain_propagates_nan_and_keeps_other_rows():
    x = torch.tensor([[1.0, float("nan"), 0.5, 0.0],
                      [1.0, -2.0, 0.5, 0.25]])
    keys = np.array([[0, 1], [2, 3]], np.uint32)
    out = int8_quant.quantize_plain(x, keys)
    assert torch.isnan(out[0]).all()
    torch.testing.assert_close(out[1], int8_quant.quantize_plain(
        x[1:], keys[1:])[0], rtol=0, atol=0)


# ---------------------------------------------------------------- EF tree

SHAPES = {"conv1": {"w": (5, 5, 1, 3), "b": (3,)},
          "fc2": {"w": (70, 5), "b": (5,)}}          # |θ| = 433


def _tree(rng, scale=1.0):
    return {lay: {n: (rng.normal(size=s) * scale).astype(np.float32)
                  for n, s in v.items()} for lay, v in SHAPES.items()}


@pytest.mark.parametrize("spec_s", ["topk:0.1", "int8", "topk:0.25+int8",
                                    "topk:1.0"])
def test_ef_compress_tree_matches_reference(spec_s):
    """Over several events from the same (g, e): y leaf for leaf exactly
    as JAX's jitted event, e' = (g + e) − y exactly, ‖e'‖ to 1e-6
    relative. Under ``jit`` XLA fuses JAX's e' = x − q·scale into one
    multiply-add, which skips the rounding of the transmitted y: with
    int8 in the spec JAX's e' then differs from x − y by at most half an
    ulp of y; without it (y = x or 0) the two are equal."""
    rng = np.random.default_rng(4)
    spec, jspec = compress.parse_compress(spec_s), \
        jcompress.parse_compress(spec_s)
    jfn = jax.jit(lambda g, e, k: jcompress.ef_compress(g, e, jspec, k))
    e = jax.tree.map(lambda a: a * 1e-3, _tree(rng))
    for t in range(4):
        g = _tree(rng, 10.0 ** (t - 2))
        key = jax.random.PRNGKey(t)
        ry, re, rerr = jfn(jax.tree.map(jnp.asarray, g),
                           jax.tree.map(jnp.asarray, e), key)
        y, e_t, err = compress.ef_compress(
            convert.params_from_jax(g, "cpu"),
            convert.params_from_jax(e, "cpu"), spec, np.asarray(key))
        ymax = max(float(np.abs(np.asarray(v)).max())
                   for v in jax.tree.leaves(ry))
        for lay in SHAPES:
            for n in SHAPES[lay]:
                yv, ev = y[lay][n].numpy(), e_t[lay][n].numpy()
                np.testing.assert_array_equal(yv, np.asarray(ry[lay][n]))
                np.testing.assert_array_equal(ev, (g[lay][n] + e[lay][n])
                                              - yv)
                atol = np.spacing(np.float32(ymax)) / 2 if spec.int8 else 0
                np.testing.assert_allclose(ev, np.asarray(re[lay][n]),
                                           rtol=0, atol=atol)
        np.testing.assert_allclose(float(err), float(rerr), rtol=1e-6)
        e = jax.tree.map(np.asarray, re)


@pytest.mark.parametrize("spec_s", ["topk:0.05", "int8", "topk:0.2+int8"])
def test_ef_rows_telescope(spec_s):
    """Σ_t y_t + e_T = Σ_t g_t on every row (f32 additions), and the
    residual is (g + e) − y exactly at each event."""
    spec = compress.parse_compress(spec_s)
    rng = np.random.default_rng(5)
    n, p4, m = 1001, 1004, 3
    e = torch.zeros(m, p4)
    sum_y, sum_g = torch.zeros(m, p4), torch.zeros(m, p4)
    for t in range(6):
        g = torch.zeros(m, p4)
        g[:, :n] = torch.from_numpy(rng.normal(size=(m, n)).astype(
            np.float32))
        keys = np.asarray(jax.random.split(jax.random.PRNGKey(t), m))
        y, e_new, err = compress.ef_compress_rows(g, e, n, spec, keys)
        assert torch.equal(e_new, (g + e) - y)
        torch.testing.assert_close(err, e_new.norm(dim=1))
        assert not y[:, n:].any() and not e_new[:, n:].any()
        e = e_new
        sum_y += y
        sum_g += g
    torch.testing.assert_close(sum_y + e, sum_g, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- host loop

SMALL = dict(num_groups=4, devices_per_group=8, num_selected=4,
             num_presampled=1, iters_per_round=3, rounds=2, lr=0.05)


@pytest.fixture(scope="module")
def run_setup():
    part = make_partition(PartitionConfig(num_factories=4,
                                          devices_per_factory=8, seed=0))
    params = jax.tree.map(np.asarray, jcnn.init_cnn(
        jax.random.PRNGKey(0), jcfg.smoke_config()))
    return part, params


def _run_both(run_setup, robust=None, **cfg):
    part, params = run_setup
    corrupt = dict(mode="scale+nan_burst", frac=0.25, prob=0.5)
    jkw, kw = {}, {}
    if robust:
        jkw["corrupt_fn"] = jstreaming.make_corruption_fn(
            jstreaming.CorruptionConfig(**corrupt), 0, 32)
        kw["corrupt_fn"] = make_corruption_fn(CorruptionConfig(**corrupt), 0)
        cfg = dict(cfg, robust_agg=robust, quarantine_limit=2)
    else:
        jkw["group_loss_fn"] = jcnn.make_group_loss_fn()
    _, ref = jfedgs.run_fedgs(
        jax.tree.map(jnp.asarray, params), jcnn.loss_fn,
        JFactoryStreams(part, batch_size=8, seed=0), part.p_real,
        jfedgs.FedGSConfig(**SMALL, batch_size=8, **cfg), **jkw)
    _, out = fedgs.run_fedgs(
        convert.params_from_jax(params, "cpu"),
        FactoryStreams(part, batch_size=8, seed=0), part.p_real,
        fedgs.FedGSConfig(**SMALL, **cfg),
        group_loss_fn=cnn.make_group_loss_fn(), **kw)
    assert len(ref) == len(out) == SMALL["rounds"]
    for r, o in zip(ref, out):
        assert o.loss == pytest.approx(r.loss, abs=1e-5)
        assert o.divergence == pytest.approx(r.divergence, abs=1e-5)
        assert o.reselections == r.reselections
        assert (o.bytes_int, o.bytes_ext) == (r.bytes_int, r.bytes_ext)
        # 1e-5 in round 0; after it the f32 gradients' last-bit
        # differences have flipped a few stochastic roundings (see
        # test_compress_cli_matches_reference): up to 1.04e-5 in round 1
        rel = 1e-5 if r.round == 0 else 1e-4
        assert o.compress_error == pytest.approx(r.compress_error, rel=rel)
    return ref, out


@pytest.mark.parametrize("ci,ce", [("topk:0.1", "none"), ("int8", "int8"),
                                   ("topk:0.1+int8", "topk:0.01")])
def test_run_fedgs_records_match_reference(run_setup, ci, ce):
    ref, out = _run_both(run_setup, compress_int=ci, compress_ext=ce)
    n = sum(v.size for lv in run_setup[1].values() for v in lv.values())
    pay = compress.payload_bytes
    assert out[0].bytes_int == 2 * pay(n, compress.parse_compress(ci)) * \
        SMALL["iters_per_round"] * 16
    assert out[0].bytes_ext == 2 * pay(n, compress.parse_compress(ce)) * 4


def test_run_fedgs_robust_compress_matches_reference(run_setup):
    """Compression after robust aggregation: faults seated, flags and
    rollbacks (NaN guard with the residual rolled back too) equal."""
    ref, out = _run_both(run_setup, robust="trimmed_mean",
                         compress_int="topk:0.1+int8")
    for r, o in zip(ref, out):
        assert o.corrupted_selected == r.corrupted_selected
        assert o.rollbacks == r.rollbacks
        assert o.clipped_fraction == pytest.approx(r.clipped_fraction)
    assert sum(o.corrupted_selected for o in out) > 0


def test_none_spec_keeps_the_uncompressed_path(run_setup):
    """Both specs 'none': no key draws beyond the main chain, no residual,
    no compress_error; topk:1.0 transmits every coordinate exactly."""
    part, params = run_setup
    outs = []
    for ci in ("none", "topk:1.0"):
        _, logs = fedgs.run_fedgs(
            convert.params_from_jax(params, "cpu"),
            FactoryStreams(part, batch_size=8, seed=0), part.p_real,
            fedgs.FedGSConfig(**SMALL, compress_int=ci),
            group_loss_fn=cnn.make_group_loss_fn())
        outs.append(logs)
    for a, b in zip(*outs):
        assert (a.loss, a.divergence) == (b.loss, b.divergence)
    assert np.isnan(outs[0][0].compress_error)
    assert outs[1][0].compress_error == 0.0


def test_compress_config_matches_reference_validation():
    for bad in (dict(compress_int="gzip"), dict(compress_ext="topk:2.0"),
                dict(compress_int="int8", train_step="model_avg")):
        with pytest.raises(ValueError):
            jfedgs.FedGSConfig(**bad)
        with pytest.raises(ValueError):
            fedgs.FedGSConfig(**bad)
    fedgs.FedGSConfig(compress_ext="int8", train_step="model_avg")
    assert fedgs.FedGSConfig().compress_int == \
        jfedgs.FedGSConfig().compress_int == "none"


def test_compress_rows_use_the_ported_kernels():
    from repro_torch.core import dispatch
    assert dispatch.KERNELS["topk_compress"] is topk_compress
    assert dispatch.KERNELS["int8_quant"] is int8_quant
    assert set(dispatch.launch_counts()) >= {"topk_compress", "int8_quant"}


# -------------------------------------------------------------------- CLI

CLI_FLAGS = [
    ["--compress-int", "topk:0.01+int8", "--compress-ext", "int8"],
    ["--compress-int", "int8", "--compress-ext", "topk:0.01"],
    ["--corrupt", "scale+nan_burst", "--corrupt-frac", "0.25",
     "--quarantine-limit", "2", "--robust-agg", "trimmed_mean",
     "--compress-int", "topk:0.1+int8"],
]


@pytest.mark.parametrize("flags", CLI_FLAGS, ids=["int-topk+int8_ext-int8",
                                                  "int-int8_ext-topk",
                                                  "robust+int-topk+int8"])
def test_compress_cli_matches_reference(flags, capsys, monkeypatch,
                                        tmp_path):
    """Round lines as ``assert_cli_matches`` holds them; the ``--log-json``
    ledgers: bytes exact, ``compress_error`` to 1e-5 in round 0. Later
    rounds agree to 1e-2 only: the EF event is exact on equal inputs
    (above), but the two frameworks' f32 gradients differ in the last
    bits, and stochastic rounding turns a coordinate whose y − floor(y)
    lies within that difference of its uniform draw into a whole-quantum
    difference, which the following iterations carry on (1e-8–1e-6 in
    round 0, up to 1.4e-3 by round 2 on these runs)."""
    ref_log = tmp_path / "ref.json"
    recs = assert_cli_matches(capsys, monkeypatch, flags, ref_log=ref_log)
    ref = json.loads(ref_log.read_text())
    for r, o in zip(ref, recs):
        assert (o["bytes_int"], o["bytes_ext"]) == \
            (r["bytes_int"], r["bytes_ext"])
        rel = 1e-5 if r["round"] == 0 else 1e-2
        assert o["compress_error"] == pytest.approx(r["compress_error"],
                                                    rel=rel)
