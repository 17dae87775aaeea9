"""The dense-LM serving slice of the port against the JAX package: configs,
layers, init, the flash-attention kernel's plain version, prefill and
KV-cache decode, the token stream and the serve CLI."""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import lm_data as jlm_data
from repro.kernels.flash_attention import ops as jfa
from repro.launch import serve as jserve
from repro.models import attention as jattention
from repro.models import build as jbuild
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro_torch import configs, convert
from repro_torch.core import dispatch, prng
from repro_torch.data.lm_data import MarkovLMStream
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve
from repro_torch.models import attention, build, layers, transformer

TOL = dict(rtol=0, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these tests run thousands of small CPU ops, and
    under parallel test workers the default thread pool per worker
    oversubscribes the cores (a threefry init then takes minutes, not a
    second)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().cpu().float().numpy()


def _jax_params(arch, seed=0):
    cfg = jconfigs.get_smoke_config(arch)
    params = jbuild(cfg).init(jax.random.PRNGKey(seed))
    return cfg, params, convert.params_from_jax(
        jax.tree.map(np.asarray, params), "cpu")


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_equal_reference(arch):
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    for ported, ref in ((configs.get_config(arch), jconfigs.get_config(arch)),
                        (configs.get_smoke_config(arch),
                         jconfigs.get_smoke_config(arch))):
        for f in dataclasses.fields(ref):
            a, b = getattr(ported, f.name), getattr(ref, f.name)
            if f.name.endswith("_dtype"):
                assert (a, b) == (torch.float32, jnp.float32), f.name
            else:
                assert a == b, (f.name, a, b)
        for prop in ("head_dim", "padded_vocab", "has_attention", "d_inner",
                     "ssm_heads"):
            assert getattr(ported, prop) == getattr(ref, prop), prop
        assert ported.param_count() == ref.param_count()
        assert ported.param_count(active_only=True) == \
            ref.param_count(active_only=True)


def test_shapes_and_vocab_padding_equal_reference():
    assert configs.INPUT_SHAPES == {
        k: configs.InputShape(*dataclasses.astuple(v))
        for k, v in jconfigs.INPUT_SHAPES.items()}
    assert configs.VOCAB_PAD == jconfigs.base.VOCAB_PAD
    for v in (1, 255, 256, 257, 49_155, 151_936):
        assert configs.pad_vocab(v) == jconfigs.pad_vocab(v)
    assert configs.get_config("granite-3-2b").param_count() == 2_635_071_488


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rmsnorm_rope_embed_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 16, 4, 32)).astype(np.float32) * 3
    scale = rng.normal(size=(32,)).astype(np.float32)
    pos = np.broadcast_to(np.arange(100, 116, dtype=np.int32), (2, 16))
    np.testing.assert_allclose(
        _np(layers.rmsnorm({"scale": torch.tensor(scale)}, torch.tensor(x))),
        np.asarray(jlayers.rmsnorm({"scale": scale}, x)), rtol=0, atol=1e-6)
    for xx in (x, x[:, :, 0]):   # with and without the head axis
        np.testing.assert_allclose(
            _np(layers.apply_rope(torch.tensor(xx), torch.tensor(pos))),
            np.asarray(jlayers.apply_rope(xx, pos)), rtol=0, atol=1e-6)
    table = (rng.normal(size=(64, 32)) * 0.02).astype(np.float32)  # init's
    toks = rng.integers(0, 64, (2, 16)).astype(np.int32)
    emb = layers.embed({"table": torch.tensor(table)}, torch.tensor(toks))
    np.testing.assert_array_equal(
        _np(emb), np.asarray(jlayers.embed({"table": table}, toks)))
    h = np.asarray(jlayers.rmsnorm({"scale": scale}, x[:, :, 0]))
    np.testing.assert_allclose(
        _np(layers.unembed({"table": torch.tensor(table)}, torch.tensor(h))),
        np.asarray(jlayers.unembed({"table": table}, h)), rtol=0, atol=1e-6)


def test_rope_rotates_halves():
    """RoPE pairs dimension i with i + D/2 (not 2i with 2i + 1)."""
    x = torch.zeros(1, 1, 8)
    x[..., 0] = 1.0
    out = layers.apply_rope(x, torch.tensor([[1]]))
    freq0 = layers.rope_frequencies(8)[0]
    assert out[0, 0, 4] == pytest.approx(float(torch.sin(freq0)))
    assert out[0, 0, 1] == 0.0


@pytest.mark.parametrize("gated", [True, False], ids=["swiglu", "gelu_tanh"])
def test_mlp_matches_reference(gated):
    key = jax.random.PRNGKey(3)
    p = jax.tree.map(np.asarray, jlayers.init_mlp(key, 32, 64, gated=gated))
    x = np.random.default_rng(1).normal(size=(2, 5, 32)).astype(np.float32)
    out = layers.mlp(convert.params_from_jax(p, "cpu"), torch.tensor(x))
    np.testing.assert_allclose(_np(out), np.asarray(jlayers.mlp(p, x)),
                               rtol=0, atol=1e-6)
    if not gated:   # jax.nn.gelu is the tanh form: the exact erf form is off
        h = torch.tensor(x) @ torch.tensor(p["up"]["w"])
        assert float((torch.nn.functional.gelu(h)
                      - torch.nn.functional.gelu(h, approximate="tanh"))
                     .abs().max()) > 1e-5


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen1.5-4b",
                                  "whisper-large-v3"])
def test_init_matches_reference_leaf_by_leaf(arch):
    """``init_lm(PRNGKey(0))`` draws the JAX package's numbers (whisper:
    ``init_encdec``, the enc-dec stack with the gelu MLP's two matrices)."""
    if arch == "whisper-large-v3":
        cfg = jconfigs.get_smoke_config(arch)
        ref = jbuild(cfg).init(jax.random.PRNGKey(0))
        got = build(configs.get_smoke_config(arch)).init(prng.PRNGKey(0),
                                                         "cpu")
        assert "gate" not in got["decoder"]["mlp"]
    else:
        cfg = jconfigs.get_smoke_config(arch)
        ref = jtransformer.init_lm(cfg, jax.random.PRNGKey(0))
        got = transformer.init_lm(configs.get_smoke_config(arch),
                                  prng.PRNGKey(0), "cpu")
    ref_leaves = list(_leaves(jax.tree.map(np.asarray, ref)))
    got_leaves = list(_leaves(got))
    assert [k for k, _ in ref_leaves] == [k for k, _ in got_leaves]
    for (name, r), (_, g) in zip(ref_leaves, got_leaves):
        assert tuple(g.shape) == r.shape, name
        np.testing.assert_allclose(_np(g), r, rtol=0, atol=1e-6,
                                   err_msg=str(name))


def test_init_with_a_generator_has_the_tree():
    cfg = configs.get_smoke_config("qwen1.5-4b")
    p = transformer.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    q = transformer.init_lm(cfg, prng.PRNGKey(0), "cpu")
    assert [(k, tuple(v.shape)) for k, v in _leaves(p)] == \
        [(k, tuple(v.shape)) for k, v in _leaves(q)]
    assert layers.num_params(p) == layers.num_params(q)


# ---------------------------------------------------------------------------
# flash attention: the port's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

MASKS = [(True, None), (True, 96), (False, None)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,s,d", [
    (1, 4, 4, 256, 64), (2, 8, 2, 128, 32), (1, 4, 1, 256, 128),
    pytest.param(2, 8, 8, 128, (48, 32), id="2-8-8-128-48-32"),
    pytest.param(1, 4, 2, 128, (192, 128), id="1-4-2-128-192-128")])
def test_flash_attention_matches_pallas(b, h, kv, s, d, dtype):
    """The Pallas kernel (interpret mode) against the port's wrapper on CPU
    tensors and its plain version, on the JAX package's sweep and MLA's
    (D, Dv) pairs (``d`` a pair: q/k of D, v of Dv)."""
    d, dv = d if isinstance(d, tuple) else (d, d)
    rng = np.random.default_rng(b * 100 + h)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    arrs = [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, dv))]
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrs)
    tq, tk, tv = (torch.tensor(a).to(tdt) for a in arrs)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    bq = min(128, s)
    for causal, window in MASKS:
        ref = np.asarray(jfa.flash_attention(
            jq, jk, jv, causal=causal, window=window, block_q=bq,
            block_k=bq).astype(jnp.float32))
        out = fa.flash_attention(tq, tk, tv, causal=causal, window=window,
                                 block_q=bq, block_k=bq)
        assert out.dtype == tdt and tuple(out.shape) == (b, s, h, dv)
        plain = fa.attention_plain(tq.transpose(1, 2), tk.transpose(1, 2),
                                   tv.transpose(1, 2), causal=causal,
                                   window=window).transpose(1, 2)
        for got in (out, plain):
            err = float(np.abs(_np(got) - ref).max())
            assert err < tol, (causal, window, err)


def test_flash_attention_fully_masked_rows_take_the_pallas_form():
    """A sliding window smaller than the tile leaves rows with no key in a
    tile that the kernel still computes; NEG_INF = -1e30 keeps them finite
    (with -inf the same rows give NaN) and the first unmasked key wipes
    their terms out."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=(1, 256, 2, 32)).astype(np.float32)
               for _ in range(3))
    ref = np.asarray(jfa.flash_attention(q, k, v, causal=True, window=3))
    out = fa.flash_attention(*(torch.tensor(a) for a in (q, k, v)),
                             causal=True, window=3)
    assert np.isfinite(_np(out)).all()
    np.testing.assert_allclose(_np(out), ref, rtol=0, atol=2e-5)
    # the three-key window, by hand, for the last row
    s = (q[0, -1, 0] @ k[0, -3:, 0].T) / np.sqrt(32)
    w = np.exp(s - s.max())
    np.testing.assert_allclose(_np(out)[0, -1, 0],
                               (w / w.sum()) @ v[0, -3:, 0], atol=1e-5)


def test_flash_attention_precondition():
    t = torch.zeros(1, 192, 2, 32)
    with pytest.raises(ValueError, match="multiples"):
        fa.flash_attention(t, t, t)
    fa.flash_attention(t, t, t, block_q=64, block_k=64)
    with pytest.raises(ValueError):
        fa.flash_attention(t, t, t, block_q=64, block_k=64, window=0)


@pytest.mark.parametrize("d,dv", [(64, 32), (48, 48), (96, 96), (192, 64)])
def test_flash_attention_refuses_untaken_head_dims(d, dv):
    """A (D, Dv) pair the kernel does not take raises on the CPU too,
    naming the pairs it takes."""
    q = torch.zeros(1, 128, 2, d)
    v = torch.zeros(1, 128, 2, dv)
    with pytest.raises(ValueError, match=r"\(48, 32\), \(192, 128\)"):
        fa.flash_attention(q, q, v)


def test_flash_wrapper_never_falls_back(monkeypatch, tmp_path):
    """A CUDA tensor goes to the kernel or raises: here there is no nvcc,
    so it raises (fake CUDA tensors stand in for a card's). A meta tensor
    takes the explicit shape route, the plain version's shape arithmetic,
    and launches nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def no_nvcc():
        raise RuntimeError("no nvcc")

    monkeypatch.setattr(kbuild, "_LIB", None)
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kbuild, "find_nvcc", no_nvcc)
    with FakeTensorMode(), pytest.raises(RuntimeError, match="no nvcc"):
        q = torch.empty(1, 128, 2, 64, device="cuda")
        fa.flash_attention(q, q, q)
    before = fa.LAUNCHES
    meta = torch.empty(1, 128, 2, 64, device="meta")
    out = fa.flash_attention(meta, meta[:, :, :1], meta[:, :, :1])
    assert out.device.type == "meta" and tuple(out.shape) == (1, 128, 2, 64)
    assert fa.LAUNCHES == before
    assert "flash_attention" in dispatch.launch_counts()


def test_attend_auto_resolves_as_reference():
    """``impl="auto"``: naive at 64 tokens, blockwise at 4096, local for a
    64-key window at 1024; each output equals the JAX ``attend``'s."""
    rng = np.random.default_rng(0)
    for s, window in ((64, None), (4096, None), (1024, 64)):
        q = rng.normal(size=(1, s, 2, 32)).astype(np.float32)
        k, v = (rng.normal(size=(1, s, 1, 32)).astype(np.float32)
                for _ in range(2))
        ref = np.asarray(jattention.attend(q, k, v, window=window))
        out = attention.attend(*(torch.tensor(a) for a in (q, k, v)),
                               window=window)
        assert tuple(out.shape) == (1, s, 2, 32)
        np.testing.assert_allclose(_np(out), ref, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# forward (prefill) and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape,window", [
    ("granite-3-2b", (2, 128), None), ("granite-3-2b", (1, 256), 64),
    ("qwen1.5-4b", (2, 128), None)])
def test_forward_pallas_matches_reference(arch, shape, window):
    cfg, jparams, params = _jax_params(arch)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, shape,
                                             dtype=np.int32)
    ref, _ = jtransformer.forward(cfg, jparams, toks, window=window,
                                  attn_impl="pallas")
    dispatch.reset_launch_counts()
    logits, aux = transformer.forward(configs.get_smoke_config(arch), params,
                                      torch.tensor(toks), window=window,
                                      attn_impl="pallas")
    assert dispatch.launch_counts()["flash_attention"] == 0   # CPU tensors
    assert tuple(logits.shape) == shape + (cfg.padded_vocab,)
    assert float(aux) == 0.0
    np.testing.assert_allclose(_np(logits), np.asarray(ref), **TOL)
    naive, _ = transformer.forward(configs.get_smoke_config(arch), params,
                                   torch.tensor(toks), window=window,
                                   attn_impl="naive")
    np.testing.assert_allclose(_np(naive), np.asarray(ref), **TOL)


@pytest.mark.parametrize("windowed", [False, True], ids=["plain", "ring"])
def test_decode_steps_match_reference(windowed):
    """8 decode steps; the ring buffer cut to 4 slots so that it wraps."""
    arch = "granite-3-2b"
    cfg, jparams, params = _jax_params(arch)
    tcfg = configs.get_smoke_config(arch)
    if windowed:
        cfg, tcfg = cfg.with_(sliding_window=4), tcfg.with_(sliding_window=4)
    fns, jfns = build(tcfg), jbuild(cfg)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 8),
                                             dtype=np.int32)
    jcache = jfns.init_decode_cache(2, 8, windowed=windowed)
    cache = fns.init_decode_cache(2, 8, windowed=windowed, device="cpu")
    assert cache["layers"]["k"].shape == jcache["layers"]["k"].shape
    for i in range(8):
        ref, jcache = jfns.decode_step(jparams, jcache, toks[:, i:i + 1],
                                       jnp.int32(i), windowed=windowed)
        out, cache = fns.decode_step(params, cache,
                                     torch.tensor(toks[:, i:i + 1]), i,
                                     windowed=windowed)
        np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(cache["layers"][name]),
                                   np.asarray(jcache["layers"][name]), **TOL)


def test_decode_cache_write_clamps_like_dynamic_update_slice():
    """Past the cache's end the write lands on the last slot."""
    cfg = configs.get_smoke_config("granite-3-2b")
    p = transformer._index(transformer.init_lm(cfg, prng.PRNGKey(0),
                                               "cpu")["layers"], 0)["attn"]
    jcfg = jconfigs.get_smoke_config("granite-3-2b")
    from repro.models import attention as jattention
    x = np.random.default_rng(3).normal(size=(1, 1, 256)).astype(np.float32)
    cache = attention.init_kv_cache(cfg, 1, 4, "cpu")
    jcache = jattention.init_kv_cache(jcfg, 1, 4)
    out, cache = attention.gqa_decode(p, torch.tensor(x), cache, 6, cfg)
    ref, jcache = jattention.gqa_decode(
        jax.tree.map(lambda t: jnp.asarray(_np(t)), p), x, jcache,
        jnp.int32(6), jcfg)
    np.testing.assert_allclose(_np(cache["k"]), np.asarray(jcache["k"]),
                               **TOL)
    assert float(cache["k"][0, 3].abs().sum()) > 0
    np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)


@pytest.mark.parametrize("arch", ["granite-3-2b", "granite-8b", "qwen1.5-4b"])
def test_decode_matches_prefill(arch):
    """The port's incremental decode reproduces its own teacher-forced
    forward (the JAX package's test, its tolerance)."""
    cfg = configs.get_smoke_config(arch)
    fns = build(cfg)
    params = fns.init(prng.PRNGKey(0), "cpu")
    toks = torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 128), dtype=np.int32))
    full = fns.forward(params, {"tokens": toks}, attn_impl="pallas")
    cache = fns.init_decode_cache(1, 128, device="cpu")
    outs = []
    for i in range(16):
        lg, cache = fns.decode_step(params, cache, toks[:, i:i + 1], i)
        outs.append(lg)
    err = float((torch.cat(outs, 1) - full[:, :16]).abs().max())
    assert err < 5e-4, err


def test_windowed_ring_decode_matches_windowed_prefill():
    cfg = configs.get_smoke_config("granite-8b").with_(sliding_window=4)
    fns = build(cfg)
    params = fns.init(prng.PRNGKey(0), "cpu")
    toks = torch.tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, 10), dtype=np.int32))
    full, _ = transformer.forward(cfg, params, toks, window=4,
                                  attn_impl="naive")
    cache = fns.init_decode_cache(1, 10, windowed=True, device="cpu")
    assert cache["layers"]["k"].shape[2] == 4
    outs = []
    for i in range(10):
        lg, cache = fns.decode_step(params, cache, toks[:, i:i + 1], i,
                                    windowed=True)
        outs.append(lg)
    err = float((torch.cat(outs, 1) - full).abs().max())
    assert err < 5e-4, err


# ---------------------------------------------------------------------------
# data and the serve CLI
# ---------------------------------------------------------------------------

def test_markov_stream_bit_equal():
    for vocab, seed in ((512, 0), (97, 5)):
        a, b = MarkovLMStream(vocab, seed), jlm_data.MarkovLMStream(vocab,
                                                                    seed)
        np.testing.assert_array_equal(a.trans, b.trans)
        np.testing.assert_array_equal(a.sample(3, 40), b.sample(3, 40))
        for x, y in zip(a.batch(2, 9).values(), b.batch(2, 9).values()):
            np.testing.assert_array_equal(x, y)


def _ids(text):
    line = [ln for ln in text.splitlines() if ln.startswith("sample")]
    assert len(line) == 1, text
    return line[0]


@pytest.mark.parametrize("flags", [
    ["--arch", "granite-3-2b"], ["--arch", "granite-8b", "--seed", "3"],
    ["--arch", "qwen1.5-4b"],
    ["--arch", "granite-3-2b", "--windowed", "--prompt-len", "40", "--gen",
     "40"]], ids=["granite-3-2b", "granite-8b", "qwen1.5-4b", "windowed"])
def test_serve_cli_prints_reference_token_ids(flags, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve"] + flags)
    jserve.main()
    ref = capsys.readouterr().out
    res = serve.main(flags + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert _ids(out) == _ids(ref)
    assert out.splitlines()[0].split(" total")[0] == \
        ref.splitlines()[0].split(" total")[0]
    assert res["tokens"].shape == (4, 40 if "--windowed" in flags else 32)


def test_serve_cli_defaults_to_cuda_and_refuses_without_a_card(monkeypatch):
    assert serve.build_parser().get_default("device") == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "granite-3-2b"])
    assert not torch.backends.cuda.matmul.allow_tf32
