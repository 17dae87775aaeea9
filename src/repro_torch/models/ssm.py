"""Mamba2 SSD (state-space duality) blocks — arXiv:2405.21060.

The port of the JAX package's ``models/ssm.py``, with its parameter tree
and layouts. Chunked dual form: within a chunk of Q = ``cfg.ssm_chunk``
steps the output is a masked quadratic "attention-like" term; across
chunks a recurrent state (B, H, N, P) is carried, by a Python loop over
the chunks where the JAX package runs a ``lax.scan``. ``ssd_reference``
materialises the full S×S semiseparable matrix (the test oracle).

``mamba_forward`` sends the scan to ``kernels.ssd_scan.ssd_scan`` (the
CUDA kernel for CUDA tensors, :func:`ssd_chunked` for CPU tensors) when
the kernel's contract holds: no initial state in and no final state out,
as in every ``transformer.forward``. With a state in or out it runs
:func:`ssd_chunked` on any device.

Decode is the O(1) recurrent update: h ← h·exp(dtA) + dt·B⊗x, y = C·h.

Parity notes: ``jax.nn.softplus`` is ``logaddexp(x, 0)``, written here as
``max(x, 0) + log1p(exp(-|x|))`` (``F.softplus`` takes ``log1p(exp(x))``
below its threshold, which rounds otherwise); ``init_mamba_block`` splits
its key six ways and uses four; the gated norm inside the block takes the
layers' default eps, not ``cfg.norm_eps``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ssd_scan as kssd
from .layers import he_init, init_rmsnorm, normal, rmsnorm, split


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def init_mamba_block(key, cfg, device, *, dtype=None) -> dict:
    dtype = dtype or cfg.param_dtype
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    W = cfg.ssm_conv_width
    conv_ch = di + 2 * N
    ks = split(key, 6)
    return {
        # in_proj emits [x (di), z (di), B (N), C (N)]; dt has its own proj
        "in_proj": {"w": he_init(ks[0], (d, 2 * di + 2 * N), device, dtype)},
        "dt_proj": {"w": he_init(ks[1], (d, H), device, dtype),
                    "bias": torch.zeros(H, dtype=torch.float32,
                                        device=device)},
        "conv_w": (normal(ks[2], (W, conv_ch), device) * 0.1).to(dtype),
        "conv_b": torch.zeros(conv_ch, dtype=dtype, device=device),
        "A_log": torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                        device=device)),
        "D": torch.ones(H, dtype=torch.float32, device=device),
        "norm": init_rmsnorm(di, device, dtype),
        "out_proj": {"w": he_init(ks[3], (di, d), device, dtype)},
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d. x (B,S,C), w (W,C)."""
    W = w.shape[0]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
              for i in range(W))
    return out + b[None, None, :]


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular pairwise cumulative sums: out[i,j] = Σ_{j<t<=i} a_t
    (−inf above the diagonal)."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(q, q, dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int,
                init_state: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    Args:
      x: (Bt, S, H, P) inner activations. dt: (Bt, S, H) (post-softplus).
      A: (H,) negative decay rates. B, C: (Bt, S, N) (ngroups=1).
      chunk: intra-chunk length Q; S must be a multiple of it.
      init_state: optional (Bt, H, N, P) initial state.
    Returns: (y (Bt,S,H,P), final_state (Bt,H,N,P)).
    """
    bt, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"ssd_chunked: S={s} is not a multiple of "
                         f"chunk={chunk}")
    nc = s // chunk
    xr = x.reshape(bt, nc, chunk, h, p)
    dtr = dt.reshape(bt, nc, chunk, h)
    Br = B.reshape(bt, nc, chunk, n)
    Cr = C.reshape(bt, nc, chunk, n)

    a = dtr * A[None, None, None, :]                      # (bt,nc,Q,H)
    a_hq = a.movedim(-1, -2)                              # (bt,nc,H,Q)
    cum = torch.cumsum(a_hq, dim=-1)                      # (bt,nc,H,Q)
    Lmat = torch.exp(_segsum(a_hq))                       # (bt,nc,H,Q,Q)

    # intra-chunk (diagonal blocks): Y_ij = (C_i·B_j) L_ij dt_j x_j
    G = torch.einsum("bcin,bcjn->bcij", Cr, Br)           # (bt,nc,Q,Q)
    xd = xr * dtr[..., None]                              # dt-weighted input
    M = G[:, :, None] * Lmat                              # (bt,nc,H,Q,Q)
    y_diag = torch.einsum("bchij,bcjhp->bcihp", M, xd)

    # per-chunk new-state contribution: Σ_j exp(cum_Q − cum_j) B_j ⊗ dt_j x_j
    decay_state = torch.exp(cum[..., -1:] - cum)          # (bt,nc,H,Q)
    states = torch.einsum("bchj,bcjn,bcjhp->bchnp",
                          decay_state, Br, xd)            # (bt,nc,H,N,P)
    chunk_decay = torch.exp(cum[..., -1])                 # (bt,nc,H)

    st = init_state if init_state is not None else \
        torch.zeros(bt, h, n, p, dtype=x.dtype, device=x.device)
    st = st.float()
    states, chunk_decay = states.float(), chunk_decay.float()
    prev = []
    for c in range(nc):                                   # the lax.scan
        prev.append(st)
        st = st * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                # (bt,nc,H,N,P)

    # inter-chunk (off-diagonal): Y_i += exp(cum_i) C_i · S_prev
    state_decay = torch.exp(cum)                          # (bt,nc,H,Q)
    y_off = torch.einsum("bcin,bchnp,bchi->bcihp",
                         Cr.float(), prev_states, state_decay)
    y = (y_diag.float() + y_off).reshape(bt, s, h, p)
    return y.to(x.dtype), st.to(x.dtype)


def ssd_reference(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Naive O(S²) semiseparable materialisation (oracle)."""
    a = (dt * A[None, None, :]).movedim(-1, -2)           # (bt,H,S)
    Lmat = torch.exp(_segsum(a))                          # (bt,H,S,S)
    G = torch.einsum("bin,bjn->bij", C, B)                # (bt,S,S)
    M = G[:, None] * Lmat
    xd = x * dt[..., None]
    return torch.einsum("bhij,bjhp->bihp", M, xd)


def mamba_forward(p: dict, x: torch.Tensor, cfg, *, init_state=None,
                  return_state: bool = False):
    """Full Mamba2 block: in_proj → conv → SSD → gated norm → out_proj."""
    bt, s, d = x.shape
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    P = cfg.ssm_head_dim
    proj = torch.matmul(x, p["in_proj"]["w"].to(x.dtype))
    xi, z, Bv, Cv = torch.split(proj, [di, di, N, N], dim=-1)
    xBC = torch.cat([xi, Bv, Cv], dim=-1)
    xBC = F.silu(_causal_conv(xBC, p["conv_w"].to(x.dtype),
                              p["conv_b"].to(x.dtype)))
    xi, Bv, Cv = torch.split(xBC, [di, N, N], dim=-1)
    dt = softplus(torch.matmul(x, p["dt_proj"]["w"].to(x.dtype)).float()
                  + p["dt_proj"]["bias"])                 # (bt,S,H)
    A = -torch.exp(p["A_log"])                            # (H,)
    xh = xi.reshape(bt, s, H, P)
    chunk = min(cfg.ssm_chunk, s)          # short sequences: single chunk
    if init_state is None and not return_state:
        y, state = kssd.ssd_scan(xh, dt, A, Bv, Cv, chunk=chunk), None
    else:
        y, state = ssd_chunked(xh, dt, A, Bv, Cv, chunk,
                               init_state=init_state)
    y = y + xh * p["D"].to(y.dtype)[None, None, :, None]  # skip connection
    y = y.reshape(bt, s, di).to(x.dtype)
    y = rmsnorm(p["norm"], y * F.silu(z))
    out = torch.matmul(y, p["out_proj"]["w"].to(x.dtype))
    if return_state:
        return out, state
    return out


def init_ssm_state(cfg, batch: int, device, dtype=None) -> dict:
    dtype = dtype or cfg.compute_dtype
    H, N, P = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    conv_ch = cfg.d_inner + 2 * N
    return {
        "h": torch.zeros(batch, H, N, P, dtype=dtype, device=device),
        "conv": torch.zeros(batch, cfg.ssm_conv_width - 1, conv_ch,
                            dtype=dtype, device=device),
    }


def mamba_decode(p: dict, x: torch.Tensor, state: dict, cfg
                 ) -> tuple[torch.Tensor, dict]:
    """One-token recurrent update. x (B,1,d). Returns the output and a new
    state dict (``h`` carried in f32, written back in the state's dtype)."""
    bt = x.shape[0]
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    proj = torch.matmul(x, p["in_proj"]["w"].to(x.dtype))
    xi, z, Bv, Cv = torch.split(proj, [di, di, N, N], dim=-1)
    xBC = torch.cat([xi, Bv, Cv], dim=-1)                 # (B,1,C)
    conv_buf = torch.cat([state["conv"], xBC], dim=1)     # (B,W,C)
    w = p["conv_w"].to(x.dtype)
    out = torch.sum(conv_buf * w[None], dim=1, keepdim=True) \
        + p["conv_b"].to(x.dtype)[None, None]
    xBC = F.silu(out)
    new_conv = conv_buf[:, 1:]
    xi, Bv, Cv = torch.split(xBC, [di, N, N], dim=-1)
    dt = softplus(torch.matmul(x, p["dt_proj"]["w"].to(x.dtype)).float()
                  + p["dt_proj"]["bias"])[:, 0]           # (B,H)
    A = -torch.exp(p["A_log"])
    xh = xi.reshape(bt, H, P)
    Bv, Cv = Bv[:, 0], Cv[:, 0]                           # (B,N)
    h = state["h"].float()
    decay = torch.exp(dt * A[None, :])                    # (B,H)
    h = h * decay[..., None, None] + torch.einsum(
        "bn,bhp,bh->bhnp", Bv.float(), xh.float(), dt)
    y = torch.einsum("bn,bhnp->bhp", Cv.float(), h)
    y = y + xh.float() * p["D"][None, :, None]
    y = y.reshape(bt, 1, di).to(x.dtype)
    y = rmsnorm(p["norm"], y * F.silu(z))
    out = torch.matmul(y, p["out_proj"]["w"].to(x.dtype))
    return out, {"h": h.to(state["h"].dtype), "conv": new_conv}
