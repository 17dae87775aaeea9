"""The enc-dec serving slice of the port against the JAX package:
whisper-large-v3 on its smoke config (init, encoder, teacher-forced
decoder, the cross cache, decode) and the serve CLI's refusal. The
attention paths it adds (flash at Sq != Sk, ``blockwise``, ``local``,
``attend(impl="auto")``) are held in ``test_torch_attention_paths.py``."""
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
from repro.models import encdec as jencdec
from repro_torch import configs, convert
from repro_torch.core import prng
from repro_torch.launch import serve
from repro_torch.models import attention, build, encdec, transformer

ARCH = "whisper-large-v3"


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


def _close_scaled(got, ref, tol=1e-5):
    """To ``tol`` of max(1, max |ref|)."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(_np(got), ref, rtol=0,
                               atol=tol * max(1.0, float(np.abs(ref).max())))


@functools.lru_cache(maxsize=None)
def _jax_model():
    """(JAX cfg, JAX params as numpy, the port's cfg, the same params as
    tensors)."""
    cfg = jconfigs.get_smoke_config(ARCH)
    params = jax.tree.map(np.asarray, jbuild(cfg).init(jax.random.PRNGKey(0)))
    return cfg, params, configs.get_smoke_config(ARCH), \
        convert.params_from_jax(params, "cpu")


def _inputs(b, s_enc, s_dec, seed=1):
    cfg = configs.get_smoke_config(ARCH)
    rng = np.random.default_rng(seed)
    frames = (rng.normal(size=(b, s_enc, cfg.d_model)) * 0.1) \
        .astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (b, s_dec), dtype=np.int32)
    return frames, toks


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def test_init_matches_reference_leaf_by_leaf():
    """``init_encdec(PRNGKey(0))`` draws the JAX package's numbers: the key
    split (encoder, decoder, embed, head), the encoder layers' 2-way and
    the decoder layers' 3-way splits, the cross attention's GQA matrices,
    the gelu MLP's two, an ``lm_head`` of its own."""
    cfg, jp, tcfg, tp = _jax_model()
    got = encdec.init_encdec(tcfg, prng.PRNGKey(0), "cpu")
    ref_leaves, got_leaves = list(_leaves(jp)), list(_leaves(got))
    assert [k for k, _ in ref_leaves] == [k for k, _ in got_leaves]
    for (name, r), (_, g) in zip(ref_leaves, got_leaves):
        assert tuple(g.shape) == r.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(_np(g), r, rtol=0, atol=1e-6,
                                   err_msg=str(name))
    assert set(got["decoder"]["xattn"]) == {"wq", "wk", "wv", "wo"}
    assert "gate" not in got["encoder"]["mlp"]
    assert got["decoder"]["xattn"]["wq"]["w"].shape[0] == cfg.num_layers


def test_init_with_a_generator_has_the_tree():
    tcfg = configs.get_smoke_config(ARCH)
    p = build(tcfg).init(torch.Generator().manual_seed(0), "cpu")
    q = encdec.init_encdec(tcfg, prng.PRNGKey(0), "cpu")
    assert [(k, tuple(v.shape)) for k, v in _leaves(p)] == \
        [(k, tuple(v.shape)) for k, v in _leaves(q)]


# ---------------------------------------------------------------------------
# encoder, decoder, forward
# ---------------------------------------------------------------------------

IMPLS = [("naive", "naive"), ("naive", "pallas"), ("blockwise", "pallas"),
         ("blockwise", "blockwise")]


@pytest.mark.parametrize("jimpl,impl", IMPLS)
def test_encode_matches_reference(jimpl, impl):
    cfg, jp, tcfg, tp = _jax_model()
    frames, _ = _inputs(2, 128, 0)
    ref = jencdec.encode(cfg, jp, frames, attn_impl=jimpl)
    out = encdec.encode(tcfg, tp, torch.tensor(frames), attn_impl=impl)
    assert tuple(out.shape) == (2, 128, cfg.d_model)
    _close_scaled(out, ref)


@pytest.mark.parametrize("jimpl,impl", IMPLS)
@pytest.mark.parametrize("s_enc,s_dec", [(128, 128), (256, 128),
                                         (128, 256)])
def test_decode_train_matches_reference(jimpl, impl, s_enc, s_dec):
    """The teacher-forced decoder over the JAX encoder's output: causal
    self-attention, then cross attention with q unrotated, at Sq = Sk and
    Sq != Sk (the flash kernel's plain version non-causal there)."""
    cfg, jp, tcfg, tp = _jax_model()
    frames, toks = _inputs(2, s_enc, s_dec)
    enc = np.asarray(jencdec.encode(cfg, jp, frames, attn_impl="naive"))
    ref = jencdec.decode_train(cfg, jp, toks, enc, attn_impl=jimpl)
    out = encdec.decode_train(tcfg, tp, torch.tensor(toks),
                              torch.tensor(enc), attn_impl=impl)
    assert tuple(out.shape) == (2, s_dec, cfg.padded_vocab)
    _close_scaled(out, ref)


@pytest.mark.parametrize("jimpl,impl", IMPLS)
def test_forward_matches_reference(jimpl, impl):
    cfg, jp, tcfg, tp = _jax_model()
    frames, toks = _inputs(2, 256, 128)
    ref = jbuild(cfg).forward(jp, {"encoder_frames": frames, "tokens": toks},
                              attn_impl=jimpl)
    out = build(tcfg).forward(tp, {"encoder_frames": torch.tensor(frames),
                                   "tokens": torch.tensor(toks)},
                              attn_impl=impl)
    _close_scaled(out, ref)


def test_forward_with_a_window_matches_reference():
    """The decoder's self-attention under a window (the encoder and the
    cross attention take none)."""
    cfg, jp, tcfg, tp = _jax_model()
    frames, toks = _inputs(1, 128, 128)
    batch = {"encoder_frames": frames, "tokens": toks}
    ref = jencdec.forward(cfg, jp, batch, window=32, attn_impl="naive")
    out = encdec.forward(tcfg, tp, {k: torch.tensor(v)
                                    for k, v in batch.items()},
                         window=32, attn_impl="pallas")
    _close_scaled(out, ref)


def test_cross_attention_q_is_not_rotated():
    """With ``kv_override`` the layer uses q as projected: rotating it
    changes the output, so equality with the JAX layer pins the form."""
    cfg, jp, tcfg, tp = _jax_model()
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 16, cfg.d_model)).astype(np.float32)
    kv = [rng.normal(size=(1, 24, cfg.n_kv_heads, cfg.head_dim))
          .astype(np.float32) for _ in range(2)]
    pos = np.broadcast_to(np.arange(16) + 5, (1, 16))
    jx = jax.tree.map(lambda a: a[0], jp["decoder"]["xattn"])
    tx = transformer._index(tp["decoder"]["xattn"], 0)
    ref = jattention.gqa_forward(jx, x, pos, cfg, causal=False,
                                 impl="naive", kv_override=tuple(kv))
    out = attention.gqa_forward(tx, torch.tensor(x),
                                torch.tensor(pos.copy()), tcfg,
                                causal=False, impl="naive",
                                kv_override=tuple(map(torch.tensor, kv)))
    _close_scaled(out, ref)
    shifted = attention.gqa_forward(tx, torch.tensor(x),
                                    torch.tensor(pos.copy()) + 7, tcfg,
                                    causal=False, impl="naive",
                                    kv_override=tuple(map(torch.tensor, kv)))
    assert torch.equal(out, shifted)


def test_encoder_is_bidirectional():
    """Changing the last frame changes the first position's output."""
    cfg, jp, tcfg, tp = _jax_model()
    frames, _ = _inputs(1, 8, 0)
    out1 = encdec.encode(tcfg, tp, torch.tensor(frames))
    frames[:, -1] += 1.0
    out2 = encdec.encode(tcfg, tp, torch.tensor(frames))
    assert float((out1[:, 0] - out2[:, 0]).abs().max()) > 1e-6


# ---------------------------------------------------------------------------
# the cross cache and decode
# ---------------------------------------------------------------------------

def test_decode_cache_matches_reference():
    cfg, jp, tcfg, tp = _jax_model()
    for kw in ({}, {"enc_len": 12}, {"windowed": True}):
        ref = jencdec.init_decode_cache(cfg, 2, 80, **kw)
        got = encdec.init_decode_cache(tcfg, 2, 80, device="cpu", **kw)
        r, g = list(_leaves(ref)), list(_leaves(got))
        assert [k for k, _ in r] == [k for k, _ in g]
        for (name, a), (_, b) in zip(r, g):
            assert tuple(b.shape) == a.shape and not b.any(), name


def test_prefill_cross_cache_matches_reference():
    cfg, jp, tcfg, tp = _jax_model()
    frames, _ = _inputs(2, 12, 0)
    enc = np.asarray(jencdec.encode(cfg, jp, frames))
    ref = jencdec.prefill_cross_cache(
        cfg, jp, jencdec.init_decode_cache(cfg, 2, 8, enc_len=12), enc)
    cache = encdec.init_decode_cache(tcfg, 2, 8, enc_len=12, device="cpu")
    got = encdec.prefill_cross_cache(tcfg, tp, cache, torch.tensor(enc))
    assert got["layers"] is cache["layers"]
    for name in ("cross_k", "cross_v"):
        assert tuple(got[name].shape) == ref[name].shape
        _close_scaled(got[name], ref[name])


@pytest.mark.parametrize("windowed", [False, True], ids=["plain", "ring"])
def test_decode_matches_reference_and_teacher_forced(windowed):
    """``encode`` → ``prefill_cross_cache`` → 6 decode steps (the JAX
    package's consistency test, 12 frames): each step's logits equal the
    JAX step's, and all of them are within 5e-4 of the teacher-forced
    forward (the ring: 4 slots, wrapped, against a 4-token window)."""
    cfg, jp, tcfg, tp = _jax_model()
    b, s_enc, s_dec = 2, 12, 6
    frames, toks = _inputs(b, s_enc, s_dec)
    window = 4 if windowed else None
    c, jc = (tcfg.with_(sliding_window=4), cfg.with_(sliding_window=4)) \
        if windowed else (tcfg, cfg)
    full = encdec.forward(c, tp, {"encoder_frames": torch.tensor(frames),
                                  "tokens": torch.tensor(toks)},
                          window=window)
    enc = encdec.encode(c, tp, torch.tensor(frames))
    jenc = jencdec.encode(jc, jp, frames)
    jfns, fns = jbuild(jc), build(c)
    cache = fns.init_decode_cache(b, s_dec + 2, enc_len=s_enc,
                                  windowed=windowed, device="cpu")
    cache = encdec.prefill_cross_cache(c, tp, cache, enc)
    jcache = jencdec.prefill_cross_cache(
        jc, jp, jfns.init_decode_cache(b, s_dec + 2, enc_len=s_enc,
                                       windowed=windowed), jenc)
    outs = []
    for i in range(s_dec):
        lg, cache = fns.decode_step(tp, cache, torch.tensor(toks[:, i:i + 1]),
                                    i, windowed=windowed)
        ref, jcache = jfns.decode_step(jp, jcache, toks[:, i:i + 1],
                                       jnp.int32(i), windowed=windowed)
        _close_scaled(lg, ref)
        outs.append(lg)
    err = float((torch.cat(outs, 1) - full).abs().max())
    assert err < 5e-4, err


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_serve_refuses_encdec_with_the_reference_message(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH])
    with pytest.raises(SystemExit) as ref:
        jserve.main()
    with pytest.raises(SystemExit) as cli:
        serve.main(["--arch", ARCH, "--device", "cpu"])
    with pytest.raises(SystemExit) as lib:
        serve.serve(configs.get_smoke_config(ARCH), device="cpu")
    assert str(cli.value) == str(lib.value) == str(ref.value) == \
        "use examples/serve_lm.py for enc-dec serving"
