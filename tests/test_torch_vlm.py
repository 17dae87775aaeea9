"""The VLM serving slice of the port against the JAX package: internvl2-26b
on its smoke config (init, the vision prefix in ``forward``, decode, the
serve CLI), ``configs.input_specs`` and ``factory.make_dummy_batch`` for
every arch, and ``examples/torch_serve_lm.py`` against
``examples/serve_lm.py``."""
import functools
import importlib.util
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import build as jbuild
from repro.models import factory as jfactory
from repro.models import transformer as jtransformer
from repro_torch import configs, convert
from repro_torch.core import prng
from repro_torch.launch import serve
from repro_torch.models import build, factory, transformer

ARCH = "internvl2-26b"
EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


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


def _close_scaled(got, ref):
    """To 1e-5 of max(1, max |ref|)."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(_np(got), ref, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(ref).max())))


@functools.lru_cache(maxsize=None)
def _jax_model():
    """(JAX cfg, JAX params as numpy, the port's cfg, the same params as
    tensors)."""
    cfg = jconfigs.get_smoke_config(ARCH)
    params = jax.tree.map(np.asarray, jbuild(cfg).init(jax.random.PRNGKey(0)))
    return cfg, params, configs.get_smoke_config(ARCH), \
        convert.params_from_jax(params, "cpu")


def _inputs(b, s_vis, s_txt, seed=1):
    cfg = configs.get_smoke_config(ARCH)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s_txt), dtype=np.int32)
    vis = (rng.normal(size=(b, s_vis, cfg.d_model)) * 0.1).astype(np.float32)
    return toks, vis


# ---------------------------------------------------------------------------
# init and forward
# ---------------------------------------------------------------------------

def test_init_matches_reference_leaf_by_leaf():
    """``init_lm(PRNGKey(0))`` draws the JAX package's numbers for the VLM:
    the dense stack (gated MLPs, no biases) and an untied ``lm_head``."""
    cfg, jp, tcfg, tp = _jax_model()
    got = transformer.init_lm(tcfg, prng.PRNGKey(0), "cpu")
    ref_leaves, got_leaves = list(_leaves(jp)), list(_leaves(got))
    assert [k for k, _ in ref_leaves] == [k for k, _ in got_leaves]
    for (name, r), (_, g) in zip(ref_leaves, got_leaves):
        assert tuple(g.shape) == r.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(_np(g), r, rtol=0, atol=1e-6,
                                   err_msg=str(name))
    assert "lm_head" in got and "gate" in got["layers"]["mlp"]


@pytest.mark.parametrize("jimpl,impl", [("naive", "naive"),
                                        ("naive", "pallas"),
                                        ("blockwise", "pallas"),
                                        ("blockwise", "blockwise")])
@pytest.mark.parametrize("prefix", [True, False], ids=["prefix", "text"])
def test_forward_matches_reference(jimpl, impl, prefix):
    """``forward`` with and without ``prefix_embeds``: 32 vision embeddings
    and 96 tokens (128 positions, the flash kernel's block) give the text
    positions' logits only, to 1e-5 of max(1, max |ref|)."""
    cfg, jp, tcfg, tp = _jax_model()
    toks, vis = _inputs(2, 32, 96 if prefix else 128)
    kw = dict(prefix_embeds=vis) if prefix else {}
    ref, _ = jtransformer.forward(cfg, jp, toks, attn_impl=jimpl, **kw)
    kw = dict(prefix_embeds=torch.tensor(vis)) if prefix else {}
    out, aux = transformer.forward(tcfg, tp, torch.tensor(toks),
                                   attn_impl=impl, **kw)
    assert tuple(out.shape) == (2, toks.shape[1], cfg.padded_vocab)
    assert float(aux) == 0.0
    _close_scaled(out, ref)


def test_factory_forward_reads_vision_embeds():
    """``build(cfg).forward`` takes the batch of ``input_specs``: the
    ``vision_embeds`` go in front of the ``tokens``."""
    cfg, jp, tcfg, tp = _jax_model()
    toks, vis = _inputs(1, 16, 48)
    ref = jbuild(cfg).forward(jp, {"tokens": toks, "vision_embeds": vis},
                              attn_impl="naive")
    out = build(tcfg).forward(tp, {"tokens": torch.tensor(toks),
                                   "vision_embeds": torch.tensor(vis)},
                              attn_impl="naive")
    _close_scaled(out, ref)


def test_prefix_changes_the_text_logits():
    cfg, jp, tcfg, tp = _jax_model()
    toks, vis = _inputs(1, 4, 8)
    t = torch.tensor(toks)
    l1, _ = transformer.forward(tcfg, tp, t, prefix_embeds=torch.tensor(vis))
    l2, _ = transformer.forward(tcfg, tp, t,
                                prefix_embeds=torch.tensor(vis + 0.5))
    assert tuple(l1.shape) == (1, 8, cfg.padded_vocab)
    assert float((l1 - l2).abs().max()) > 1e-6


def test_prefix_is_cast_to_the_compute_dtype():
    """A bf16 prefix is cast to the tokens' f32 before it is concatenated:
    the logits equal those of the same prefix rounded to bf16 in f32."""
    cfg, jp, tcfg, tp = _jax_model()
    toks, vis = _inputs(1, 8, 24)
    t, v16 = torch.tensor(toks), torch.tensor(vis).bfloat16()
    a, _ = transformer.forward(tcfg, tp, t, prefix_embeds=v16)
    b, _ = transformer.forward(tcfg, tp, t, prefix_embeds=v16.float())
    assert a.dtype == torch.float32 and torch.equal(a, b)


def test_without_prefix_the_vlm_is_the_plain_lm():
    """No prefix: the VLM's forward and decode are the dense LM's, bit for
    bit, on the same params."""
    cfg, jp, tcfg, tp = _jax_model()
    dense = tcfg.with_(arch_type="dense")
    toks = torch.tensor(_inputs(2, 0, 24)[0])
    a, _ = transformer.forward(tcfg, tp, toks)
    b, _ = transformer.forward(dense, tp, toks)
    assert torch.equal(a, b)
    ca = transformer.init_decode_cache(tcfg, 2, 8, device="cpu")
    cb = transformer.init_decode_cache(dense, 2, 8, device="cpu")
    for i in range(3):
        la, ca = transformer.decode_step(tcfg, tp, ca, toks[:, i:i + 1], i)
        lb, cb = transformer.decode_step(dense, tp, cb, toks[:, i:i + 1], i)
        assert torch.equal(la, lb)


# ---------------------------------------------------------------------------
# decode and the serve CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("windowed", [False, True], ids=["plain", "ring"])
def test_decode_matches_prefill(windowed):
    """Decode (no prefix, as in the JAX package) against the prefill of
    the same tokens: a plain cache, and a ring of the smoke config's 64
    slots wrapped by 80 tokens (the prefill under the same window)."""
    cfg, jp, tcfg, tp = _jax_model()
    s = 80 if windowed else 24
    toks = torch.tensor(_inputs(1, 0, s)[0])
    window = tcfg.sliding_window if windowed else None
    full, _ = transformer.forward(tcfg, tp, toks, window=window,
                                  attn_impl="naive")
    cache = transformer.init_decode_cache(tcfg, 1, s, windowed=windowed,
                                          device="cpu")
    outs = []
    for i in range(s):
        lg, cache = transformer.decode_step(tcfg, tp, cache,
                                            toks[:, i:i + 1], i,
                                            windowed=windowed)
        outs.append(lg)
    err = float((torch.cat(outs, 1) - full).abs().max())
    assert err < 5e-4, err


def test_decode_steps_match_reference():
    cfg, jp, tcfg, tp = _jax_model()
    toks = _inputs(2, 0, 6)[0]
    jfns = jbuild(cfg)
    jcache = jfns.init_decode_cache(2, 8)
    cache = build(tcfg).init_decode_cache(2, 8, device="cpu")
    for i in range(6):
        ref, jcache = jfns.decode_step(jp, jcache, toks[:, i:i + 1], i)
        out, cache = build(tcfg).decode_step(tp, cache,
                                             torch.tensor(toks[:, i:i + 1]),
                                             i)
        _close_scaled(out, ref)


def _ids(text, prefix="sample"):
    line = [ln for ln in text.splitlines() if ln.startswith(prefix)]
    assert len(line) == 1, text
    return line[0]


@pytest.mark.parametrize("flags", [
    ["--arch", ARCH], ["--arch", ARCH, "--windowed", "--prompt-len", "40",
                       "--gen", "40"]], ids=["plain", "windowed"])
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


# ---------------------------------------------------------------------------
# input_specs and make_dummy_batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", list(configs.INPUT_SHAPES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_input_specs_match_reference(arch, shape):
    """Every input's name, order, shape and dtype at the four assigned
    shapes: enc-dec splits the sequence s // 2 frames + the rest tokens, a
    VLM int(s · frac) vision embeddings + the text tokens."""
    ref = jconfigs.input_specs(jconfigs.get_config(arch),
                               jconfigs.INPUT_SHAPES[shape])
    got = configs.input_specs(configs.get_config(arch),
                              configs.INPUT_SHAPES[shape])
    assert list(got) == list(ref)
    for name, spec in got.items():
        assert spec.shape == ref[name].shape, name
        assert str(spec.dtype).split(".")[-1] == ref[name].dtype.name, name


def test_input_specs_split_the_modalities():
    s = configs.INPUT_SHAPES["train_4k"]
    vlm = configs.input_specs(configs.get_config(ARCH), s)
    assert vlm["vision_embeds"].shape == (256, 512, 6144)
    assert vlm["tokens"].shape == vlm["labels"].shape == (256, 3584)
    whisper = configs.input_specs(configs.get_config("whisper-large-v3"), s)
    assert list(whisper) == ["encoder_frames", "tokens", "labels"]
    assert whisper["encoder_frames"].shape == (256, 2048, 1280)
    assert whisper["encoder_frames"].dtype == torch.float32
    assert whisper["tokens"].dtype == torch.int32


@pytest.mark.parametrize("arch,kind", [
    (ARCH, "train"), (ARCH, "prefill"), ("whisper-large-v3", "train"),
    ("granite-3-2b", "prefill"), ("mamba2-780m", "decode")])
def test_make_dummy_batch_matches_reference(arch, kind):
    """At a smoke shape: the integer inputs exactly, the floats to 1e-7
    (the 5e-7 of ``normal`` times 0.02), with the default and a given
    key."""
    shape = jconfigs.InputShape("smoke", 64, 2, kind)
    tshape = configs.InputShape("smoke", 64, 2, kind)
    jcfg, cfg = jconfigs.get_smoke_config(arch), configs.get_smoke_config(arch)
    for key in (None, 7):
        ref = jfactory.make_dummy_batch(
            jcfg, shape, None if key is None else jax.random.PRNGKey(key))
        got = factory.make_dummy_batch(
            cfg, tshape, None if key is None else prng.PRNGKey(key), "cpu")
        assert list(got) == list(ref)
        for name, r in ref.items():
            r = np.asarray(r)
            g = got[name]
            assert tuple(g.shape) == r.shape, name
            if np.issubdtype(r.dtype, np.integer):
                assert g.dtype == torch.int32, name
                np.testing.assert_array_equal(g.numpy(), r, err_msg=name)
            else:
                assert g.dtype == torch.float32, name
                np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-7,
                                           err_msg=name)


# ---------------------------------------------------------------------------
# examples/torch_serve_lm.py
# ---------------------------------------------------------------------------

def _example(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES /
                                                  f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("flags", [
    ["--arch", "mamba2-780m", "--gen", "12"],
    ["--arch", ARCH, "--gen", "12", "--batch", "2"],
    ["--arch", "granite-3-2b", "--gen", "12", "--windowed"]],
    ids=["mamba2-780m", ARCH, "granite-3-2b-windowed"])
def test_serve_example_prints_reference_sequence(flags, capsys, monkeypatch):
    """The example's first sequence equals the JAX example's from the same
    seed; its warm-up step runs on a cache of its own, so the mamba2
    state the timed loop starts from is the zero state."""
    monkeypatch.setattr(sys, "argv", ["serve_lm"] + flags)
    _example("serve_lm").main()
    ref = capsys.readouterr().out
    res = _example("torch_serve_lm").main(flags + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert _ids(out, "first sequence") == _ids(ref, "first sequence")
    assert out.splitlines()[0].split(": ")[0] == \
        ref.splitlines()[0].split(": ")[0]
    batch = int(flags[flags.index("--batch") + 1]) if "--batch" in flags \
        else 8
    assert res["tokens"].shape == (batch, 13)


def test_serve_example_refuses_encdec(capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve_lm", "--arch",
                                      "whisper-large-v3"])
    with pytest.raises(SystemExit) as ref:
        _example("serve_lm").main()
    with pytest.raises(SystemExit) as got:
        _example("torch_serve_lm").main(["--arch", "whisper-large-v3",
                                         "--device", "cpu"])
    assert "enc-dec serving" in str(ref.value)
    assert "enc-dec serving" in str(got.value)
