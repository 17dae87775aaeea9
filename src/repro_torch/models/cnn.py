"""The paper's 4-layer FEMNIST CNN (§VII.A).

[Conv2D(32) → MaxPool → Conv2D(64) → MaxPool → Dense(2048) → Dense(62)]

Parameters are a dict ``conv1/conv2/fc1/fc2 → {w, b}`` in the JAX
package's layouts (HWIO conv weights, (in, out) dense weights), and images
are NHWC. Both conv layers go through the fused conv-block kernel
(``kernels.conv_fused``) — grouped over the M·L·n superbatch in training,
over the C clients' own models in the baselines (:func:`make_model_api`),
with G=1 in :func:`apply` and eval — so no cuDNN (TF32) convolution ever
runs; the dense layers and the log-softmax stay plain PyTorch.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import tree
from ..core import baselines, dispatch, prng


def init_cnn(key, cfg, device: str | torch.device = "cuda") -> dict:
    """He-normal weights, zero biases. ``key`` is a threefry key
    (``core.prng.PRNGKey``), which draws the JAX package's exact bits, or a
    ``torch.Generator``."""
    c1, c2 = cfg.channels
    ksz = cfg.kernel
    # image 28x28 -> pool -> 14x14 -> pool -> 7x7
    flat = (cfg.image_size // 4) ** 2 * c2
    shapes = [((ksz, ksz, 1, c1), ksz * ksz), ((ksz, ksz, c1, c2),
                                                 ksz * ksz * c1),
              ((flat, cfg.hidden), flat), ((cfg.hidden, cfg.num_classes),
                                           cfg.hidden)]
    if isinstance(key, torch.Generator):
        draws = [torch.randn(shape, generator=key) for shape, _ in shapes]
    else:
        keys = prng.split(np.asarray(key, np.uint32), 4)
        draws = [torch.from_numpy(prng.normal(k, shape))
                 for k, (shape, _) in zip(keys, shapes)]
    ws = [(d / torch.sqrt(torch.tensor(float(fan)))).to(device)
          for d, (_, fan) in zip(draws, shapes)]
    zeros = lambda n: torch.zeros(n, dtype=torch.float32, device=device)
    return {
        "conv1": {"w": ws[0], "b": zeros(c1)},
        "conv2": {"w": ws[1], "b": zeros(c2)},
        "fc1": {"w": ws[2], "b": zeros(cfg.hidden)},
        "fc2": {"w": ws[3], "b": zeros(cfg.num_classes)},
    }


def _conv_stack(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x (G, B, H, W, 1) with grouped params → flat features (G, B, F)."""
    h = dispatch.conv_block_grouped(x, p["conv1"]["w"], p["conv1"]["b"])
    h = dispatch.conv_block_grouped(h, p["conv2"]["w"], p["conv2"]["b"])
    return h.reshape(h.shape[0], h.shape[1], -1)


def apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B, 28, 28) or (B, 28, 28, 1) → logits (B, classes)."""
    if x.dim() == 3:
        x = x[..., None]
    grouped = {name: {k: v[None] for k, v in layer.items()}
               for name, layer in params.items() if name.startswith("conv")}
    h = _conv_stack(grouped, x[None])[0]
    h = torch.relu(h @ params["fc1"]["w"] + params["fc1"]["b"])
    return h @ params["fc2"]["w"] + params["fc2"]["b"]


def features(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Per-client penultimate features: params leaves (C, ...), x (C, n,
    28, 28[, 1]) → (C, n, hidden). Each conv layer is one grouped launch
    over the C·n images, fc1 one ``torch.bmm``."""
    if x.dim() == 4:
        x = x[..., None]
    h = _conv_stack(params, x)
    return torch.relu(torch.bmm(h, params["fc1"]["w"])
                      + params["fc1"]["b"][:, None])


def head(params: dict, f: torch.Tensor) -> torch.Tensor:
    """Per-client logits: params leaves (C, ...), f (C, n, hidden) → (C, n,
    classes)."""
    return torch.bmm(f, params["fc2"]["w"]) + params["fc2"]["b"][:, None]


def make_model_api(cfg, device: str | torch.device = "cuda"
                   ) -> baselines.ModelAPI:
    """The CNN behind the baselines' model protocol. ``init`` draws one
    model (:func:`init_cnn` on ``device``); ``apply``/``features``/``head``
    take a leading client axis (params leaves (C, ...), x (C, n, ...)), the
    batched form of the JAX package's vmapped per-client calls."""
    return baselines.ModelAPI(
        init=lambda key: init_cnn(key, cfg, device),
        apply=lambda p, x: head(p, features(p, x)),
        features=features,
        head=head,
        feature_dim=cfg.hidden,
        num_classes=cfg.num_classes,
    )


def loss_fn(params: dict, batch: tuple) -> torch.Tensor:
    x, y = batch
    logp = torch.log_softmax(apply(params, x), dim=-1)
    return -torch.mean(torch.gather(logp, -1, y.long()[..., None]))


def make_group_loss_fn():
    """Grouped CNN loss for the all-groups superbatch train step:
    ``group_loss(group_params, batch) -> (M, L)``.

    ``group_params`` leaves carry a leading group axis (M, ...); ``batch``
    is ``(x (M, L, n, 28, 28[, 1]), y (M, L, n))``. Each (group, device)
    entry is the same math as :func:`loss_fn` on that device's batch, but
    each conv layer runs as ONE grouped launch over the (M·L·n)
    superbatch and the dense layers as batched matmuls."""

    def group_loss(gp: dict, batch: tuple) -> torch.Tensor:
        x, y = batch
        m, l, n = y.shape
        if x.dim() == 5:
            x = x[..., None]
        x = x.reshape((m, l * n) + tuple(x.shape[3:]))
        h = _conv_stack(gp, x)
        h = torch.relu(torch.bmm(h, gp["fc1"]["w"]) + gp["fc1"]["b"][:, None])
        logits = torch.bmm(h, gp["fc2"]["w"]) + gp["fc2"]["b"][:, None]
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, y.reshape(m, l * n, 1).long())[..., 0]
        return nll.reshape(m, l, n).mean(-1)

    return group_loss


@torch.no_grad()
def evaluate(params: dict, images, labels, batch: int = 512
             ) -> tuple[float, float]:
    """(test_loss, test_accuracy) over a dataset, batched on the host: each
    batch of at most ``batch`` images is one :func:`apply` (two
    ``conv_fused`` launches at G = 1 on the card), its summed loss and
    correct count are f32 on the device, and the sums accumulate as Python
    floats, divided by n at the end. ``images``/``labels`` are tensors (or
    arrays) on the params' device or the host; each batch moves to the
    params' device. For repeated periodic eval prefer :func:`make_eval_fn`,
    which copies the test set to the device once."""
    dev = tree.leaves(params)[0].device
    n = images.shape[0]
    tot_l, tot_c = 0.0, 0.0
    for i in range(0, n, batch):
        xb = torch.as_tensor(images[i:i + batch], dtype=torch.float32,
                             device=dev)
        yb = torch.as_tensor(labels[i:i + batch], device=dev).long()
        logits = apply(params, xb)
        logp = torch.log_softmax(logits, dim=-1)
        tot_l += float(-torch.sum(torch.gather(logp, -1, yb[:, None])))
        tot_c += float(torch.sum(logits.argmax(-1) == yb))
    return tot_l / n, tot_c / n


def make_eval_fn(images, labels, device: str | torch.device = "cuda", *,
                 batch: int = 0, apply_fn=None):
    """Test-set eval, ``eval_fn(params) -> (loss, accuracy)`` as 0-d
    tensors. The test set is copied to ``device`` once, here. ``batch`` > 0
    runs the forward over equal chunks of ``batch`` images (the test-set
    size must divide by it) to bound peak activation memory; the default
    evaluates in one forward pass. ``apply_fn(params, x) -> logits``
    overrides the forward (default: this CNN's :func:`apply`)."""
    fwd = apply_fn or apply
    tx = torch.as_tensor(np.asarray(images), dtype=torch.float32,
                         device=device)
    ty = torch.as_tensor(np.asarray(labels), device=device).long()
    n = tx.shape[0]
    if batch and n % batch:
        raise ValueError(f"test-set size {n} must divide by batch={batch}")

    @torch.no_grad()
    def eval_fn(params):
        if batch:
            logits = torch.cat([fwd(params, xb) for xb in tx.split(batch)])
        else:
            logits = fwd(params, tx)
        logp = torch.log_softmax(logits, dim=-1)
        loss = -torch.mean(torch.gather(logp, -1, ty[:, None]))
        acc = torch.mean((logits.argmax(-1) == ty).float())
        return loss, acc

    return eval_fn
