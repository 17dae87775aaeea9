"""The MoE serving slice of the port against the JAX package: the MoE layer
(router, load-balance loss, the dispatch and dense forms), MLA attention
(explicit prefill, absorbed decode over the compressed cache), and
deepseek-v2-236b and dbrx-132b end to end on their smoke configs: init,
forward and aux loss, decode, the serve CLI."""
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import attention as jattention
from repro.models import build as jbuild
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro_torch import configs, convert
from repro_torch.core import dispatch, prng
from repro_torch.launch import serve
from repro_torch.models import attention, build, moe, transformer

ARCHS = ["deepseek-v2-236b", "dbrx-132b"]
TOL = dict(rtol=0, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: small CPU ops under parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().cpu().float().numpy()


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


@functools.lru_cache(maxsize=None)
def _jax_model(arch):
    """(JAX cfg, JAX params, the port's cfg, the same params as tensors)."""
    cfg = jconfigs.get_smoke_config(arch)
    params = jax.tree.map(np.asarray,
                          jbuild(cfg).init(jax.random.PRNGKey(0)))
    return cfg, params, configs.get_smoke_config(arch), \
        convert.params_from_jax(params, "cpu")


def _close_scaled(got, ref):
    """To 1e-5 of max(1, max |ref|): he_init's fan-in of E makes the expert
    stacks' entries ~1/√E, so an MoE output on rmsnorm-scale inputs is
    O(100) at the smoke width, where an f32 ulp is already ~1e-5."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(_np(got), ref, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(ref).max())))


def _layer(tree, i=0):
    return jax.tree.map(lambda a: a[i], tree)


def _moe_inputs(arch, n, seed=0):
    """Layer 0's MoE params of ``arch`` (both packages) and (n, d) tokens."""
    cfg, jp, tcfg, tp = _jax_model(arch)
    jm = _layer(jp["layers"])["moe"]
    tm = transformer._index(tp["layers"], 0)["moe"]
    x = np.random.default_rng(seed).normal(
        size=(n, cfg.d_model)).astype(np.float32)
    return cfg, tcfg, jm, tm, x


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_reference_leaf_by_leaf(arch):
    """``init_lm(PRNGKey(0))`` draws the JAX package's numbers: the 3-D
    expert stacks (he_init's fan-in is E), the f32 router, MLA's six
    matrices and ``kv_norm``; ``convert.params_from_jax`` carries the JAX
    tree over unchanged."""
    cfg, jp, tcfg, tp = _jax_model(arch)
    got = transformer.init_lm(tcfg, prng.PRNGKey(0), "cpu")
    ref_leaves, got_leaves = list(_leaves(jp)), list(_leaves(got))
    assert [k for k, _ in ref_leaves] == [k for k, _ in got_leaves]
    assert [k for k, _ in _leaves(tp)] == [k for k, _ in got_leaves]
    for (name, r), (_, g), (_, c) in zip(ref_leaves, got_leaves,
                                         _leaves(tp)):
        assert tuple(g.shape) == r.shape == tuple(c.shape), name
        assert g.dtype == c.dtype == torch.float32, name
        np.testing.assert_allclose(_np(g), r, rtol=0, atol=1e-6,
                                   err_msg=str(name))
        np.testing.assert_array_equal(_np(c), r, err_msg=str(name))
    layer = got["layers"]
    assert tuple(layer["moe"]["w_gate"].shape) == \
        (cfg.num_layers, cfg.n_experts, cfg.d_model, cfg.d_ff)
    if cfg.kv_lora_rank:
        assert tuple(layer["attn"]["kv_norm"]["scale"].shape) == \
            (cfg.num_layers, cfg.kv_lora_rank)
        assert "shared" in layer["moe"]


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_router_and_load_balance_loss_match_reference(arch):
    cfg, tcfg, jm, tm, x = _moe_inputs(arch, 40)
    probs = moe.router_probs(tm, torch.tensor(x))
    jprobs = jmoe.router_probs(jm, x)
    np.testing.assert_allclose(_np(probs), np.asarray(jprobs), **TOL)
    gate, idx = moe.top_k(probs, cfg.top_k)
    jgate, jidx = jax.lax.top_k(jprobs, cfg.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(_np(gate), np.asarray(jgate), **TOL)
    aux = moe.load_balance_loss(probs, idx, cfg.n_experts)
    np.testing.assert_allclose(
        float(aux), float(jmoe.load_balance_loss(jprobs, jidx,
                                                 cfg.n_experts)),
        rtol=0, atol=1e-6)


def test_top_k_seats_ties_at_the_lower_index():
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                      [0.4, 0.1, 0.4, 0.1]], np.float32)
    vals, idx = moe.top_k(torch.tensor(probs), 2)
    jvals, jidx = jax.lax.top_k(probs, 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def _jax_ranks(expert_idx, n_experts):
    onehot = jax.nn.one_hot(expert_idx.reshape(-1), n_experts,
                            dtype=jnp.int32)
    return np.asarray(jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot,
                              axis=-1))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", [0.5, 4.0],
                         ids=["drops", "no_drops"])
def test_moe_dispatch_matches_reference(arch, capacity_factor):
    """The capacity form, with pairs dropped past an expert's capacity
    (their slot-0 writes are zeros, their gates zeroed) and without."""
    cfg, tcfg, jm, tm, x = _moe_inputs(arch, 64, seed=1)
    cfg = cfg.with_(capacity_factor=capacity_factor)
    tcfg = tcfg.with_(capacity_factor=capacity_factor)
    _, idx = moe.top_k(moe.router_probs(tm, torch.tensor(x)), cfg.top_k)
    rank = moe.dispatch_ranks(idx, cfg.n_experts)
    np.testing.assert_array_equal(rank.numpy(),
                                  _jax_ranks(idx.numpy(), cfg.n_experts))
    cap = moe.capacity(64, tcfg)
    assert cap == max(1, int(64 * cfg.top_k / cfg.n_experts
                             * capacity_factor))
    assert bool((rank >= cap).any()) == (capacity_factor < 1)
    out, aux = moe.moe_dispatch(tm, torch.tensor(x).reshape(2, 32, -1), tcfg)
    ref, jaux = jmoe.moe_dispatch(jm, x.reshape(2, 32, -1), cfg)
    assert tuple(out.shape) == (2, 32, cfg.d_model)
    _close_scaled(out, ref)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dense_matches_reference(arch):
    cfg, tcfg, jm, tm, x = _moe_inputs(arch, 6, seed=2)
    out, aux = moe.moe_dense(tm, torch.tensor(x).reshape(3, 2, -1), tcfg)
    ref, jaux = jmoe.moe_dense(jm, x.reshape(3, 2, -1), cfg)
    _close_scaled(out, ref)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("form", ["dispatch", "dense"])
def test_moe_forms_in_bf16_match_reference(arch, form):
    """bf16 tokens through f32 weights: the experts run in bf16 and the f32
    gate's products are added back in bf16, as the JAX package casts them;
    held to 2e-2 of max(1, max |ref|), bf16's 8-bit mantissa."""
    cfg, tcfg, jm, tm, x = _moe_inputs(arch, 64, seed=4)
    cfg, tcfg = (c.with_(capacity_factor=0.5) for c in (cfg, tcfg))
    xt = torch.tensor(x).to(torch.bfloat16)
    out, aux = getattr(moe, f"moe_{form}")(tm, xt, tcfg)
    ref, jaux = getattr(jmoe, f"moe_{form}")(
        jm, jnp.asarray(_np(xt)).astype(jnp.bfloat16), cfg)
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(_np(out), ref, rtol=0,
                               atol=2e-2 * max(1.0, float(np.abs(ref).max())))
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("offset,form", [(-1, "dense"), (0, "dispatch")],
                         ids=["4E-1", "4E"])
def test_moe_forward_switches_at_4e_tokens(arch, offset, form):
    """Fewer than 4·E tokens take the dense form, 4·E the dispatch form;
    ``decode=True`` always the dense one."""
    cfg = jconfigs.get_smoke_config(arch)
    n = 4 * cfg.n_experts + offset
    cfg, tcfg, jm, tm, x = _moe_inputs(arch, n, seed=3)
    xt = torch.tensor(x)[None]
    out, _ = moe.moe_forward(tm, xt, tcfg)
    want, _ = getattr(moe, f"moe_{form}")(tm, xt, tcfg)
    assert torch.equal(out, want)
    ref, _ = jmoe.moe_forward(jm, x[None], cfg)
    _close_scaled(out, ref)
    dec, _ = moe.moe_forward(tm, xt, tcfg, decode=True)
    assert torch.equal(dec, moe.moe_dense(tm, xt, tcfg)[0])


# ---------------------------------------------------------------------------
# MLA attention
# ---------------------------------------------------------------------------

def _mla_params():
    cfg, jp, tcfg, tp = _jax_model("deepseek-v2-236b")
    return cfg, tcfg, _layer(jp["layers"])["attn"], \
        transformer._index(tp["layers"], 0)["attn"]


@pytest.mark.parametrize("impl", ["naive", "pallas"])
@pytest.mark.parametrize("window", [None, 64], ids=["full", "window64"])
def test_mla_forward_matches_reference(impl, window):
    """The explicit form: q/k of head dim hd + dr = 48, v of hd = 32; the
    JAX side runs its Pallas kernel in interpret mode for ``pallas``."""
    cfg, tcfg, jp, tp = _mla_params()
    x = np.random.default_rng(4).normal(
        size=(2, 128, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(128, dtype=np.int32), (2, 128))
    ref = jattention.mla_forward(jp, x, pos, cfg, window=window, impl=impl)
    dispatch.reset_launch_counts()
    out = attention.attention_forward(tp, torch.tensor(x),
                                      torch.tensor(pos), tcfg,
                                      window=window, impl=impl)
    assert dispatch.launch_counts()["flash_attention"] == 0   # CPU tensors
    np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)


@pytest.mark.parametrize("windowed", [False, True], ids=["plain", "ring"])
def test_mla_decode_matches_reference(windowed):
    """10 absorbed decode steps over the compressed cache; the ring cut to
    4 slots so that it wraps."""
    cfg, tcfg, jp, tp = _mla_params()
    cap = 4 if windowed else 10
    xs = np.random.default_rng(5).normal(
        size=(10, 2, 1, cfg.d_model)).astype(np.float32)
    cache = attention.init_kv_cache(tcfg, 2, cap, "cpu")
    jcache = jattention.init_kv_cache(cfg, 2, cap)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: v.shape for k, v in jcache.items()} == \
        {"c": (2, cap, cfg.kv_lora_rank), "kr": (2, cap, cfg.rope_head_dim)}
    for i in range(10):
        ref, jcache = jattention.attention_decode(
            jp, xs[i], jcache, jnp.int32(i), cfg, windowed=windowed)
        out, cache = attention.attention_decode(tp, torch.tensor(xs[i]),
                                                cache, i, tcfg,
                                                windowed=windowed)
        np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)
        for name in ("c", "kr"):
            np.testing.assert_allclose(_np(cache[name]),
                                       np.asarray(jcache[name]), **TOL)


# ---------------------------------------------------------------------------
# the models end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_forward_and_aux_match_reference(arch, impl):
    """(2, 128) tokens: 256 ≥ 4·E, so every MoE layer takes the dispatch
    form; the aux loss is summed over the layers."""
    cfg, jp, tcfg, tp = _jax_model(arch)
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 128),
                                             dtype=np.int32)
    ref, jaux = jtransformer.forward(cfg, jp, toks, attn_impl=impl)
    logits, aux = transformer.forward(tcfg, tp, torch.tensor(toks),
                                      attn_impl=impl)
    assert tuple(logits.shape) == (2, 128, cfg.padded_vocab)
    np.testing.assert_allclose(_np(logits), np.asarray(ref), **TOL)
    assert aux.dtype == torch.float32 and float(aux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("windowed", [False, True], ids=["plain", "ring"])
def test_decode_matches_prefill(arch, windowed):
    """The port's decode reproduces its own teacher-forced forward (the
    JAX package's test and tolerance): 10 tokens, fewer than 4·E, so both
    take the dense MoE form; the ring cut to 4 slots."""
    cfg = configs.get_smoke_config(arch)
    window = 4 if windowed else None
    if windowed:
        cfg = cfg.with_(sliding_window=4)
    fns = build(cfg)
    params = _jax_model(arch)[3]
    toks = torch.tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (1, 10), dtype=np.int32))
    full, _ = transformer.forward(cfg, params, toks, window=window,
                                  attn_impl="naive")
    cache = fns.init_decode_cache(1, 10, windowed=windowed, device="cpu")
    outs = []
    for i in range(10):
        lg, cache = fns.decode_step(params, cache, toks[:, i:i + 1], i,
                                    windowed=windowed)
        outs.append(lg)
    err = float((torch.cat(outs, 1) - full).abs().max())
    assert err < 5e-4, err


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
    cfg, jp, tcfg, tp = _jax_model(arch)
    fns, jfns = build(tcfg), jbuild(cfg)
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 6),
                                             dtype=np.int32)
    jcache = jfns.init_decode_cache(2, 6)
    cache = fns.init_decode_cache(2, 6, device="cpu")
    for i in range(6):
        ref, jcache = jfns.decode_step(jp, jcache, toks[:, i:i + 1],
                                       jnp.int32(i))
        out, cache = fns.decode_step(tp, cache,
                                     torch.tensor(toks[:, i:i + 1]), i)
        np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)
    for (name, r), (_, g) in zip(_leaves(jax.tree.map(np.asarray, jcache)),
                                 _leaves(cache)):
        np.testing.assert_allclose(_np(g), r, err_msg=str(name), **TOL)


def _ids(text):
    line = [ln for ln in text.splitlines() if ln.startswith("sample")]
    assert len(line) == 1, text
    return line[0]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("windowed", [False, True], ids=["plain", "windowed"])
def test_serve_cli_prints_reference_token_ids(arch, windowed, capsys,
                                              monkeypatch):
    flags = ["--arch", arch]
    if windowed:
        flags += ["--windowed", "--prompt-len", "40", "--gen", "40"]
    monkeypatch.setattr(sys, "argv", ["serve"] + flags)
    jserve.main()
    ref = capsys.readouterr().out
    res = serve.main(flags + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert _ids(out) == _ids(ref)
    assert out.splitlines()[0].split(" total")[0] == \
        ref.splitlines()[0].split(" total")[0]
    assert res["tokens"].shape == (4, 40 if windowed else 32)


def test_build_takes_mla_on_a_dense_config():
    """MLA is a property of the attention, not of MoE: a dense config with
    ``kv_lora_rank > 0`` builds, and its cache is the compressed one."""
    cfg = configs.get_smoke_config("granite-3-2b").with_(kv_lora_rank=64,
                                                         rope_head_dim=16)
    fns = build(cfg)
    params = fns.init(prng.PRNGKey(0), "cpu")
    toks = torch.zeros(1, 4, dtype=torch.int32)
    full = fns.forward(params, {"tokens": toks})
    cache = fns.init_decode_cache(1, 4, device="cpu")
    assert set(cache["layers"]) == {"c", "kr"}
    lg, _ = fns.decode_step(params, cache, toks[:, :1], 0)
    assert float((lg[:, 0] - full[:, 0]).abs().max()) < 5e-4
