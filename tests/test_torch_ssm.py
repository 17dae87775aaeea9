"""The SSM and hybrid serving slice of the port against the JAX package:
the chunked SSD scan and its kernel's plain version, the Mamba2 block,
init, prefill and cached decode of mamba2-780m and zamba2-7b (smoke
configs), and the serve CLI."""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels.ssd_scan import ops as jssd
from repro.launch import serve as jserve
from repro.models import build as jbuild
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro_torch import configs, convert
from repro_torch.core import dispatch, prng
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ssd_scan as kssd
from repro_torch.launch import serve
from repro_torch.models import build, ssm, transformer

TOL = dict(rtol=0, atol=1e-5)
ARCHS = ["mamba2-780m", "zamba2-7b"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these tests run thousands of small CPU ops, and
    under parallel test workers the default thread pool per worker
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().cpu().float().numpy()


def _ssd_inputs(seed, bt, s, h, p, n):
    """The distributions of the JAX package's kernel tests, drawn by numpy."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(bt, s, h, p)) * 0.5).astype(np.float32)
    dt = np.logaddexp(rng.normal(size=(bt, s, h)), 0).astype(np.float32)
    A = (-np.exp(rng.normal(size=(h,)) * 0.3)).astype(np.float32)
    B = (rng.normal(size=(bt, s, n)) * 0.3).astype(np.float32)
    C = (rng.normal(size=(bt, s, n)) * 0.3).astype(np.float32)
    return x, dt, A, B, C


def _close(got, ref, tol=1e-5):
    """|got - ref| <= tol · max(1, max |ref|): the scan's f32 sums run over
    up to 512 terms of |y| up to ~6, where JAX's own result is 1.4e-5 off
    its float64 value (the form of the JAX package's kernel tolerance)."""
    ref = np.asarray(ref)
    err = float(np.abs(_np(got) - ref).max())
    assert err <= tol * max(1.0, float(np.abs(ref).max())), err


def _t(arrs):
    return [torch.tensor(a) for a in arrs]


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
# the SSD scan
# ---------------------------------------------------------------------------

SSD_SHAPES = [(1, 128, 2, 32, 16, 64), (2, 256, 4, 64, 32, 128),
              (1, 512, 8, 32, 64, 128)]      # tests/test_kernels.py's sweep


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["zero_state", "init_state"])
@pytest.mark.parametrize("bt,s,h,p,n,chunk", SSD_SHAPES)
def test_ssd_chunked_matches_reference(bt, s, h, p, n, chunk, with_state):
    x, dt, A, B, C = _ssd_inputs(s + h, bt, s, h, p, n)
    st = (np.random.default_rng(1).normal(size=(bt, h, n, p)) * 0.2
          ).astype(np.float32) if with_state else None
    y_ref, f_ref = jssm.ssd_chunked(x, dt, A, B, C, chunk, init_state=st)
    y, f = ssm.ssd_chunked(*_t((x, dt, A, B, C)), chunk,
                           init_state=None if st is None else torch.tensor(st))
    _close(y, y_ref)
    _close(f, f_ref)
    if not with_state:
        # the oracle's segment sums are differences of one f32 cumsum over
        # all S (up to 512 terms, |cum| up to ~360), which the two
        # frameworks round differently: ~2e-5 relative in exp(segsum)
        _close(ssm.ssd_reference(*_t((x, dt, A, B, C))),
               jssm.ssd_reference(x, dt, A, B, C), tol=3e-5)


def test_ssd_chunked_refuses_a_ragged_chunk():
    args = _t(_ssd_inputs(0, 1, 96, 2, 32, 16))
    with pytest.raises(ValueError, match="multiple"):
        ssm.ssd_chunked(*args, 64)
    with pytest.raises(ValueError, match="multiple"):
        kssd.ssd_scan(*args, chunk=64)
    # chunk = min(chunk, S), as ops.py takes it: one chunk of 96
    y = kssd.ssd_scan(*args, chunk=128)
    np.testing.assert_allclose(_np(y), _np(ssm.ssd_chunked(*args, 96)[0]),
                               rtol=0, atol=0)


def test_ssd_scan_plain_matches_the_pallas_kernel():
    """The port's wrapper on CPU tensors against the Pallas kernel in
    interpret mode and against JAX's ``ssd_chunked`` (JAX's own test
    tolerance, 1e-4)."""
    x, dt, A, B, C = _ssd_inputs(9, 2, 256, 4, 32, 16)
    ref_k = np.asarray(jssd.ssd_scan(x, dt, A, B, C, chunk=64,
                                     interpret=True))
    ref_m = np.asarray(jssm.ssd_chunked(x, dt, A, B, C, chunk=64)[0])
    dispatch.reset_launch_counts()
    y = kssd.ssd_scan(*_t((x, dt, A, B, C)), chunk=64)
    assert dispatch.launch_counts()["ssd_scan"] == 0          # CPU tensors
    for ref in (ref_k, ref_m):
        assert float(np.abs(_np(y) - ref).max()) < 1e-4


def test_ssd_chunked_masks_before_exp():
    """Large decays make exp(segsum) overflow above the diagonal; the
    masked entries must still be 0 (not inf·0 = NaN)."""
    x, dt, A, B, C = _ssd_inputs(3, 1, 64, 2, 32, 16)
    dt = dt * 40.0
    y = kssd.ssd_scan(*_t((x, dt, A, B, C)), chunk=64)
    assert np.isfinite(_np(y)).all()
    _close(y, jssm.ssd_chunked(x, dt, A, B, C, 64)[0])


def test_ssd_wrapper_never_falls_back(monkeypatch, tmp_path):
    """A non-CPU tensor goes to the kernel or raises: here there is no
    nvcc, so it raises."""
    def no_nvcc():
        raise RuntimeError("no nvcc")

    monkeypatch.setattr(kbuild, "_LIB", None)
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kbuild, "find_nvcc", no_nvcc)
    meta = lambda *shape: torch.empty(*shape, device="meta")
    with pytest.raises(RuntimeError, match="no nvcc"):
        kssd.ssd_scan(meta(1, 128, 2, 32), meta(1, 128, 2), meta(2),
                      meta(1, 128, 16), meta(1, 128, 16))
    assert "ssd_scan" in dispatch.launch_counts()
    assert "ssd_scan_f32" in kbuild.SIGNATURES


@pytest.mark.parametrize("shape,n4,ctas", [
    # mamba2-780m's and zamba2-7b's prefills: 4 launches, 16 / 32 chunks
    ((4, 2048, 48, 64, 128, 128), 128,
     {"gram": 192, "state": 2880, "pass": 1536, "scan": 3072}),
    ((1, 4096, 112, 64, 64, 128), 64,
     {"gram": 96, "state": 3472, "pass": 448, "scan": 3584}),
    # N padded to 4, 32-column P tiles, 64-row gram only at chunk <= 64
    ((2, 512, 3, 32, 102, 64), 104,
     {"gram": 16, "state": 42, "pass": 24, "scan": 48}),
    # one chunk: no state or pass launch
    ((1, 96, 2, 64, 16, 96), 16, {"gram": 3, "state": 0, "pass": 0,
                                  "scan": 2})])
def test_ssd_plan_scratch_and_grids(shape, n4, ctas):
    bt, s, h, p, n, chunk = shape
    lay = kssd.plan(bt, s, h, p, n, chunk)
    nc = s // chunk
    assert lay["n"] == n4 and lay["chunks"] == nc
    assert lay["gram"] == bt * nc * 128 * 128
    assert lay["states"] == bt * nc * h * n4 * p
    assert lay["decay"] == bt * nc * h
    assert lay["ctas"] == ctas
    assert tuple(lay["ctas"]) == kssd.PARTS and kssd.ALL_PARTS == 15


def test_ssd_check_inputs_refuses_what_the_kernel_cannot_take():
    args = list(_t(_ssd_inputs(0, 1, 256, 2, 32, 16)))
    kssd.check_inputs(*args, 128)
    with pytest.raises(ValueError, match="unsupported"):
        kssd.check_inputs(*args, 256)                     # chunk > 128
    with pytest.raises(ValueError, match="unsupported"):
        kssd.check_inputs(*args, 96)                      # 96 ∤ 256
    for i, bad in ((0, args[0][..., :16]), (3, torch.zeros(1, 256, 300)),
                   (1, args[1].double()), (1, args[1][:, :, :1]),
                   (4, args[4][:, :128])):
        with pytest.raises(ValueError):
            kssd.check_inputs(*(args[:i] + [bad] + args[i + 1:]), 128)
    strided = torch.zeros(1, 256, 16, 2)[..., 0]          # last stride 2
    with pytest.raises(ValueError, match="unit stride"):
        kssd.check_inputs(args[0], args[1], args[2], strided, args[4], 128)


def test_ssd_vector_ready_pads_and_copies_only_where_needed():
    proj = torch.randn(2, 64, 2 * 64 + 2 * 16)
    B, C = proj[..., 128:144], proj[..., 144:]
    assert kssd.vector_ready(B, 16) is B                  # aligned view
    # offset 1 float: strided, and contiguous (which .contiguous() keeps)
    for odd in (torch.randn(2, 64, 21)[..., 1:],
                torch.randn(2 * 64 * 20 + 1)[1:].view(2, 64, 20)):
        assert odd.data_ptr() % 16
        ready = kssd.vector_ready(odd, 20)
        assert ready.is_contiguous() and ready.data_ptr() % 16 == 0
        assert torch.equal(ready, odd)
    padded = kssd.vector_ready(torch.randn(2, 64, 13), 16)
    assert padded.shape == (2, 64, 16) and not padded[..., 13:].any()
    # zero columns of B and C leave the scan unchanged (plain version)
    x, dt, A, B, C = _t(_ssd_inputs(4, 1, 128, 2, 32, 13))
    _close(ssm.ssd_chunked(x, dt, A, kssd.vector_ready(B, 16),
                           kssd.vector_ready(C, 16), 64)[0],
           _np(ssm.ssd_chunked(x, dt, A, B, C, 64)[0]))


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------

def test_softplus_is_jax_logaddexp():
    """The JAX form max(x, 0) + log1p(exp(-|x|)): equal to
    ``jax.nn.softplus`` within one f32 ulp (the two frameworks' exp and
    log1p differ in the last bit), on both sides of F.softplus's
    threshold of 20."""
    x = np.concatenate([np.linspace(-30, 30, 20001),
                        np.random.default_rng(0).normal(size=5000) * 4]
                       ).astype(np.float32)
    np.testing.assert_allclose(_np(ssm.softplus(torch.tensor(x))),
                               np.asarray(jax.nn.softplus(x)), rtol=2.5e-7,
                               atol=0)


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 40, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    np.testing.assert_allclose(
        _np(ssm._causal_conv(*_t((x, w, b)))),
        np.asarray(jssm._causal_conv(x, w, b)), rtol=0, atol=1e-6)


def _block(arch="mamba2-780m"):
    jcfg = jconfigs.get_smoke_config(arch)
    jp = jssm.init_mamba_block(jax.random.PRNGKey(3), jcfg)
    return (jcfg, configs.get_smoke_config(arch), jp,
            convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu"))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_mamba_block_matches_reference(arch):
    """Six-way key split (four used), f32 dt bias, A_log = log(1..H)."""
    jcfg, cfg, jp, _ = _block(arch)
    got = ssm.init_mamba_block(prng.PRNGKey(3), cfg, "cpu")
    ref = list(_leaves(jax.tree.map(np.asarray, jp)))
    out = list(_leaves(got))
    assert [k for k, _ in ref] == [k for k, _ in out]
    for (name, r), (_, g) in zip(ref, out):
        assert g.dtype == torch.float32 and tuple(g.shape) == r.shape, name
        np.testing.assert_allclose(_np(g), r, rtol=0, atol=1e-6,
                                   err_msg=str(name))


@pytest.mark.parametrize("s", [128, 256, 40], ids=["one_chunk",
                                                    "two_chunks", "short"])
def test_mamba_forward_matches_reference(s):
    jcfg, cfg, jp, p = _block()
    x = np.random.default_rng(5).normal(size=(2, s, cfg.d_model)
                                        ).astype(np.float32)
    ref = jssm.mamba_forward(jp, x, jcfg)
    np.testing.assert_allclose(_np(ssm.mamba_forward(p, torch.tensor(x),
                                                     cfg)),
                               np.asarray(ref), **TOL)


def test_mamba_forward_with_state_matches_reference():
    """A state in and out takes ``ssd_chunked`` (never the kernel)."""
    jcfg, cfg, jp, p = _block()
    rng = np.random.default_rng(6)
    x = rng.normal(size=(1, 128, cfg.d_model)).astype(np.float32)
    st = (rng.normal(size=(1, cfg.ssm_heads, cfg.ssm_state,
                           cfg.ssm_head_dim)) * 0.1).astype(np.float32)
    ref, ref_st = jssm.mamba_forward(jp, x, jcfg, init_state=st,
                                     return_state=True)
    out, out_st = ssm.mamba_forward(p, torch.tensor(x), cfg,
                                    init_state=torch.tensor(st),
                                    return_state=True)
    np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)
    np.testing.assert_allclose(_np(out_st), np.asarray(ref_st), **TOL)


def test_mamba_decode_matches_reference():
    jcfg, cfg, jp, p = _block()
    rng = np.random.default_rng(7)
    jstate = jssm.init_ssm_state(jcfg, 2)
    state = ssm.init_ssm_state(cfg, 2, "cpu")
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: v.shape for k, v in jstate.items()}
    for _ in range(6):
        x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        ref, jstate = jssm.mamba_decode(jp, x, jstate, jcfg)
        out, state = ssm.mamba_decode(p, torch.tensor(x), state, cfg)
        np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)
        for k in ("h", "conv"):
            assert state[k].dtype == torch.float32
            np.testing.assert_allclose(_np(state[k]), np.asarray(jstate[k]),
                                       **TOL)


# ---------------------------------------------------------------------------
# the LM stack: init, prefill, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_matches_reference_leaf_by_leaf(arch):
    ref = jtransformer.init_lm(jconfigs.get_smoke_config(arch),
                               jax.random.PRNGKey(0))
    got = transformer.init_lm(configs.get_smoke_config(arch),
                              prng.PRNGKey(0), "cpu")
    ref_leaves = list(_leaves(jax.tree.map(np.asarray, ref)))
    got_leaves = list(_leaves(got))
    assert [k for k, _ in ref_leaves] == [k for k, _ in got_leaves]
    for (name, r), (_, g) in zip(ref_leaves, got_leaves):
        assert tuple(g.shape) == r.shape, name
        np.testing.assert_allclose(_np(g), r, rtol=0, atol=1e-6,
                                   err_msg=str(name))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_the_ssm_trees(arch):
    cfg, jparams, params = _jax_params(arch)
    ref = jax.tree.map(np.asarray, jparams)
    back = convert.params_to_numpy(params)
    assert [k for k, _ in _leaves(back)] == [k for k, _ in _leaves(ref)]
    for (name, r), (_, g) in zip(_leaves(ref), _leaves(back)):
        np.testing.assert_array_equal(g, r, err_msg=str(name))


@pytest.mark.parametrize("arch,shape,window,impl", [
    ("mamba2-780m", (2, 128), None, "pallas"),
    ("mamba2-780m", (1, 256), None, "pallas"),
    ("zamba2-7b", (2, 128), None, "pallas"),
    ("zamba2-7b", (1, 256), 64, "pallas"),
    ("zamba2-7b", (2, 128), None, "naive")])
def test_forward_matches_reference(arch, shape, window, impl):
    cfg, jparams, params = _jax_params(arch)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, shape,
                                             dtype=np.int32)
    ref, _ = jtransformer.forward(cfg, jparams, toks, window=window,
                                  attn_impl=impl)
    dispatch.reset_launch_counts()
    logits, aux = transformer.forward(configs.get_smoke_config(arch), params,
                                      torch.tensor(toks), window=window,
                                      attn_impl=impl)
    assert not any(dispatch.launch_counts().values())        # CPU tensors
    assert tuple(logits.shape) == shape + (cfg.padded_vocab,)
    assert float(aux) == 0.0
    np.testing.assert_allclose(_np(logits), np.asarray(ref), **TOL)


@pytest.mark.parametrize("arch,windowed", [
    ("mamba2-780m", False), ("zamba2-7b", False), ("zamba2-7b", True)],
    ids=["mamba2-780m", "zamba2-7b", "zamba2-7b-ring"])
def test_decode_steps_match_reference(arch, windowed):
    """8 decode steps; zamba2's ring buffer cut to 4 slots so that it
    wraps. The SSM states and the per-segment KV caches equal JAX's."""
    cfg, jparams, params = _jax_params(arch)
    tcfg = configs.get_smoke_config(arch)
    if windowed:
        cfg, tcfg = cfg.with_(sliding_window=4), tcfg.with_(sliding_window=4)
    fns, jfns = build(tcfg), jbuild(cfg)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 8),
                                             dtype=np.int32)
    jcache = jfns.init_decode_cache(2, 8, windowed=windowed)
    cache = fns.init_decode_cache(2, 8, windowed=windowed, device="cpu")
    assert [(k, tuple(v.shape)) for k, v in _leaves(cache)] == \
        [(k, v.shape) for k, v in _leaves(jcache)]
    for i in range(8):
        ref, jcache = jfns.decode_step(jparams, jcache, toks[:, i:i + 1],
                                       jnp.int32(i), windowed=windowed)
        out, cache = fns.decode_step(params, cache,
                                     torch.tensor(toks[:, i:i + 1]), i,
                                     windowed=windowed)
        np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)
    for (name, r), (_, g) in zip(_leaves(jax.tree.map(np.asarray, jcache)),
                                 _leaves(cache)):
        np.testing.assert_allclose(_np(g), r, **TOL, err_msg=str(name))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch):
    """The port's recurrent decode reproduces its own chunked prefill (the
    JAX package's test, its tolerance)."""
    cfg = configs.get_smoke_config(arch)
    fns = build(cfg)
    params = fns.init(prng.PRNGKey(0), "cpu")
    toks = torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 128), dtype=np.int32))
    full = fns.forward(params, {"tokens": toks}, attn_impl="pallas")
    cache = fns.init_decode_cache(1, 128, device="cpu")
    outs = []
    for i in range(24):
        lg, cache = fns.decode_step(params, cache, toks[:, i:i + 1], i)
        outs.append(lg)
    err = float((torch.cat(outs, 1) - full[:, :24]).abs().max())
    assert err < 5e-4, err


@pytest.mark.parametrize("arch,what", [
    ("dbrx-132b", "moe"), ("deepseek-v2-236b", "moe"),
    ("internvl2-26b", "vlm"), ("whisper-large-v3", "encoder-decoder"),
    ("granite-3-2b", "MLA")])
def test_build_still_refuses_the_other_families(arch, what):
    cfg = configs.get_smoke_config(arch)
    if what == "MLA":
        cfg = cfg.with_(kv_lora_rank=64)
    with pytest.raises(NotImplementedError, match=f"{what}.*ROADMAP item 18"):
        build(cfg)


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------

def _ids(text):
    line = [ln for ln in text.splitlines() if ln.startswith("sample")]
    assert len(line) == 1, text
    return line[0]


@pytest.mark.parametrize("flags", [
    ["--arch", "mamba2-780m"], ["--arch", "zamba2-7b"],
    ["--arch", "zamba2-7b", "--windowed", "--prompt-len", "40", "--gen",
     "40", "--seed", "2"]],
    ids=["mamba2-780m", "zamba2-7b", "zamba2-7b-windowed"])
def test_serve_cli_prints_reference_token_ids(flags, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve"] + flags)
    jserve.main()
    ref = capsys.readouterr().out
    dispatch.reset_launch_counts()
    res = serve.main(flags + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert _ids(out) == _ids(ref)
    assert out.splitlines()[0].split(" total")[0] == \
        ref.splitlines()[0].split(" total")[0]
    assert res["tokens"].shape == (4, 40 if "--windowed" in flags else 32)
    assert not any(dispatch.launch_counts().values())
