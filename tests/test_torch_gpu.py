"""The port's CUDA kernels against their plain versions, on the card.

Run on a machine with a CUDA card:  python -m pytest -m gpu tests/test_torch_gpu.py
Every test here skips without one.
"""
import pytest
import torch

from repro_torch.core import dispatch, gbp_cs as core_gbp
from repro_torch.kernels import agg_weighted, conv_fused, gbp_cs, robust_agg

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_gbp_cs_kernel_matches_plain(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    for g, f, k, l_sel in ((4, 10, 20, 6), (10, 62, 33, 8), (3, 62, 7, 7)):
        A = torch.randint(0, 8, (g, f, k), generator=gen,
                          device=cuda).float()
        y = A.sum(-1) * (l_sel / k) + torch.rand(g, f, generator=gen,
                                                 device=cuda)
        for x0 in (core_gbp.init_mpinv(A, y, l_sel),
                   core_gbp.init_zero(A, y, l_sel)):
            x0 = x0.contiguous()
            out = gbp_cs.minimize(A, y, x0, 64)
            ref = gbp_cs.minimize_plain(A, y, x0, 64)
            assert torch.equal(out[0], ref[0])
            assert torch.equal(out[2], ref[2])
            torch.testing.assert_close(out[1], ref[1], rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(out[3], ref[3], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("g,b,h,cin,cout", [(10, 8, 28, 1, 32),
                                            (10, 8, 14, 32, 64),
                                            (1, 40, 28, 1, 32),
                                            (4, 4, 28, 1, 8),
                                            (4, 4, 14, 8, 16)])
def test_conv_kernel_matches_plain(cuda, g, b, h, cin, cout):
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.rand(g, b, h, h, cin, generator=gen, device=cuda)
    w = torch.randn(g, 25 * cin, cout, generator=gen, device=cuda) / 5
    bias = torch.randn(g, cout, generator=gen, device=cuda)
    pat = conv_fused.im2col(x, (5, 5))
    out, y = conv_fused.fused(pat, w, bias, h)
    out_p, y_p = conv_fused.fused_plain(pat, w, bias, h)
    torch.testing.assert_close(y, y_p, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(out, out_p, rtol=1e-5, atol=1e-4)


def test_agg_kernel_matches_plain(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    for k, p in ((1, 4), (10, 4096), (7, 1_000_004)):
        x = torch.randn(k, p, generator=gen, device=cuda)
        w = torch.rand(k, generator=gen, device=cuda)
        torch.testing.assert_close(agg_weighted.agg(x, w),
                                   agg_weighted.agg_plain(x, w),
                                   rtol=1e-5, atol=1e-6)


def test_wrappers_count_launches_and_check_inputs(cuda):
    dispatch.reset_launch_counts()
    agg_weighted.agg(torch.ones(2, 8, device=cuda),
                     torch.ones(2, device=cuda))
    assert dispatch.launch_counts()["agg_weighted"] == 1
    with pytest.raises(ValueError):
        agg_weighted.agg(torch.ones(2, 6, device=cuda),
                         torch.ones(2, device=cuda))
    with pytest.raises(ValueError):
        agg_weighted.agg(torch.ones(2, 8, device=cuda, dtype=torch.float64),
                         torch.ones(2, device=cuda))
    with pytest.raises(ValueError, match="boundary"):   # float4 loads
        agg_weighted.agg(torch.ones(17, device=cuda)[1:].reshape(2, 8),
                         torch.ones(2, device=cuda))
    assert dispatch.launch_counts()["agg_weighted"] == 1


@pytest.mark.parametrize("method", robust_agg.METHODS)
def test_robust_agg_kernel_matches_plain(cuda, method):
    """Medians are exact; trimmed sums run in ascending order in both, but
    the plain version's reduction may group them otherwise (a few ulps of
    the inputs)."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    for m, k, p in ((1, 1, 5), (3, 7, 1000), (10, 10, 100_003), (2, 35, 517),
                    (2, 64, 300)):
        x = torch.randn(m, k, p, generator=gen, device=cuda)
        x[:, k // 2] = x[:, 0]                     # exact ties between rows
        active = (torch.rand(m, k, generator=gen, device=cuda) > 0.3).float()
        active[0] = 0.0                            # a group with n = 0
        for trim in (0, 1, 4, 40):
            out = robust_agg.aggregate(x, active, method, trim)
            ref = robust_agg.aggregate_plain(x, active, method, trim)
            if method == "coord_median":
                assert torch.equal(out, ref)
            else:
                torch.testing.assert_close(out, ref, rtol=0, atol=2e-6)
    with pytest.raises(ValueError, match="K <= 64"):
        robust_agg.aggregate(torch.ones(1, 65, 4, device=cuda),
                             torch.ones(1, 65, device=cuda), method)
