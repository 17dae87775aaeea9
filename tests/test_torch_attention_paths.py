"""The attention paths of the enc-dec and VLM slice against the JAX
package: the flash kernel's plain version at Sq != Sk (the cross
attention) and its refusal of a mask there, ``blockwise_attention``,
``local_attention`` and ``attend(impl="auto")``."""
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa
from repro.models import attention as jattention
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: small CPU ops under parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().cpu().float().numpy()


# ---------------------------------------------------------------------------
# flash attention at Sq != Sk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sq,sk,h,kv", [(128, 512, 4, 4), (512, 128, 4, 2),
                                        (128, 256, 8, 2)])
def test_flash_cross_shape_matches_reference(sq, sk, h, kv):
    """The plain version (the CPU path) at Sq != Sk, non-causal, D = 64,
    against the JAX package's Pallas kernel in interpret mode."""
    rng = np.random.default_rng(sq + sk)
    q = rng.normal(size=(1, sq, h, 64)).astype(np.float32)
    k, v = (rng.normal(size=(1, sk, kv, 64)).astype(np.float32)
            for _ in range(2))
    ref = np.asarray(jfa.flash_attention(q, k, v, causal=False,
                                         interpret=True))
    out = fa.flash_attention(*(torch.tensor(a) for a in (q, k, v)),
                             causal=False)
    assert tuple(out.shape) == (1, sq, h, 64)
    np.testing.assert_allclose(_np(out), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("causal,window", [(True, None), (False, 64),
                                           (True, 64)])
def test_flash_refuses_a_mask_at_sq_ne_sk(causal, window):
    """No model asks for a causal or windowed attention at Sq != Sk, and
    the kernel refuses one; so does the CPU path."""
    q, k = torch.zeros(1, 128, 2, 64), torch.zeros(1, 256, 2, 64)
    with pytest.raises(ValueError, match="Sq=128 != Sk=256"):
        fa.flash_attention(q, k, k, causal=causal, window=window)


# ---------------------------------------------------------------------------
# blockwise and local attention, attend(impl="auto")
# ---------------------------------------------------------------------------

def _qkv(b, sq, sk, h, kv, d, dv, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, d)).astype(np.float32),
            rng.normal(size=(b, sk, kv, d)).astype(np.float32),
            rng.normal(size=(b, sk, kv, dv)).astype(np.float32))


@pytest.mark.parametrize("causal,window", [(True, None), (True, 20),
                                           (False, None), (False, 20)])
@pytest.mark.parametrize("shape", [(2, 64, 64, 4, 2, 32, 32),
                                   (1, 64, 64, 4, 4, 48, 32),
                                   (1, 32, 96, 4, 1, 32, 32)],
                         ids=["gqa", "d-ne-dv", "sq-ne-sk"])
def test_blockwise_matches_reference(shape, causal, window):
    """16-row q blocks over 32-key blocks: the online softmax and its masks
    (causal, a window, both), GQA, D != Dv and Sq != Sk, against the JAX
    package's ``blockwise_attention`` and against the naive form."""
    q, k, v = _qkv(*shape)
    ref = np.asarray(jattention.blockwise_attention(
        q, k, v, causal=causal, window=window, block_q=16, block_k=32))
    t = [torch.tensor(a) for a in (q, k, v)]
    out = attention.blockwise_attention(*t, causal=causal, window=window,
                                        block_q=16, block_k=32)
    assert tuple(out.shape) == shape[:2] + (shape[3], shape[6])
    np.testing.assert_allclose(_np(out), ref, rtol=0, atol=1e-5)
    naive = attention.naive_attention(*t, causal=causal, window=window)
    np.testing.assert_allclose(_np(out), _np(naive), rtol=0, atol=1e-5)


def test_blockwise_clamps_its_blocks_to_a_short_sequence():
    """Blocks of 512 on a 64-token sequence become one block (the JAX
    package's regression test)."""
    q, k, v = _qkv(1, 64, 64, 4, 2, 32, 32)
    t = [torch.tensor(a) for a in (q, k, v)]
    out = attention.blockwise_attention(*t, causal=True)
    ref = np.asarray(jattention.blockwise_attention(q, k, v, causal=True))
    np.testing.assert_allclose(_np(out), ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        _np(out), _np(attention.naive_attention(*t, causal=True)),
        rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="multiples"):
        attention.blockwise_attention(*t, causal=True, block_q=48)


@pytest.mark.parametrize("window,block", [(20, 16), (16, 16), (5, 16),
                                          (40, 32)])
@pytest.mark.parametrize("shape", [(2, 96, 96, 4, 2, 32, 32),
                                   (1, 64, 64, 4, 4, 48, 32)],
                         ids=["gqa", "d-ne-dv"])
def test_local_matches_reference(shape, window, block):
    """The gathered window blocks (clamped and masked below block 0), a
    window of one block, shorter than one and over two blocks."""
    q, k, v = _qkv(*shape)
    ref = np.asarray(jattention.local_attention(q, k, v, window=window,
                                                block=block))
    t = [torch.tensor(a) for a in (q, k, v)]
    out = attention.local_attention(*t, window=window, block=block)
    np.testing.assert_allclose(_np(out), ref, rtol=0, atol=1e-5)
    naive = attention.naive_attention(*t, causal=True, window=window)
    np.testing.assert_allclose(_np(out), _np(naive), rtol=0, atol=1e-5)


@pytest.mark.parametrize("sq,sk,window,causal,picks", [
    (64, 64, None, True, "naive"), (1024, 1024, 64, True, "local"),
    (1024, 1024, 64, False, "local"), (4096, 4096, None, True, "blockwise"),
    (2560, 2560, None, False, "blockwise"), (512, 4096, None, False,
                                             "blockwise"),
    (2048, 2048, None, True, "naive"), (1000, 1000, 64, True, "naive")])
def test_attend_auto_matches_reference(sq, sk, window, causal, picks,
                                       monkeypatch):
    """``attend(impl="auto")`` picks the JAX package's path at each length
    (local for a window shorter than Sq = Sk, a multiple of 512, even
    non-causal as the JAX rule has it; blockwise past 2048 on multiples
    of 512; else naive), and its output equals the JAX ``attend``'s."""
    q, k, v = _qkv(1, sq, sk, 2, 1, 16, 16, seed=sq)
    ref = np.asarray(jattention.attend(q, k, v, causal=causal, window=window,
                                       impl="auto"))
    seen = []
    for name in ("naive_attention", "blockwise_attention",
                 "local_attention"):
        fn = getattr(attention, name)
        monkeypatch.setattr(attention, name,
                            lambda *a, _fn=fn, _n=name, **kw:
                            seen.append(_n.split("_")[0]) or _fn(*a, **kw))
    out = attention.attend(*(torch.tensor(a) for a in (q, k, v)),
                           causal=causal, window=window)
    assert seen == [picks]
    np.testing.assert_allclose(_np(out), ref, rtol=0, atol=1e-5)
