"""Classical CNN baseline on the same federated harness.

Counterpart of ``qfedx_tpu/models/cnn.py`` (``TinyCNN``,
``make_tiny_cnn``; BASELINE.md config 3): conv(→16, 5×5, same) → ReLU →
maxpool2 → conv(→32, 5×5, same) → ReLU → maxpool2 → dense(64) → ReLU →
dropout(0.5) → dense(num_classes).

The parameter dict keeps the reference's pytree keys AND layouts —
``Conv_0``/``Conv_1`` kernels HWIO (5, 5, in, out), ``Dense_0``/``Dense_1``
kernels (in, out), biases (out,) — so a checkpoint written by either
package restores in the other as it is (``run/checkpoint.py``), and
``params_from_jax`` (``models/api.py``) converts nothing but the array
type. ``forward`` transposes to torch's layouts per call: inputs arrive
NHWC, the convolutions run NCHW, and the feature map goes back to NHWC
before the flatten, because ``Dense_0``'s rows are in flax's (h, w, c)
order.

The convolutions run in full f32 on the card (``_Conv5x5``: cuDNN with
TF32 off in the forward and the backward), whatever the process's
``torch.backends.cudnn.allow_tf32`` says; the dense layers follow the
process's matmul settings, as every matmul of the port does.

Dropout runs only in ``apply_train(params, x, draws)``: ``draws
["dropout_keep"]`` is the step's (B, 64) bool mask (the ``StepDraw``
``dropout_keep``, kept with probability 0.5, drawn by
``fed/round.RoundDraws``), survivors scaled by 1/0.5. ``apply`` is
deterministic (the reference's ``train=False``).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from qfedx_tpu_torch.models.api import (  # noqa: F401 — re-exported
    Model,
    StepDraw,
    params_from_jax,
)
from qfedx_tpu_torch.utils import pins

_KERNEL = 5
_PAD = _KERNEL // 2  # flax "SAME" at stride 1
# flax's lecun_normal: a normal truncated to ±2σ, rescaled to unit
# variance by this constant (the std of the standard normal on [−2, 2]).
_TRUNC_STD = 0.87962566103423978


@contextlib.contextmanager
def _full_f32_conv():
    """cuDNN convolutions without TF32 for the block, the process's
    setting restored after (a process-wide flag: CNN forwards of two
    threads set the same value)."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


class _Conv5x5(torch.autograd.Function):
    """``F.conv2d(x, w, b, padding=2)`` with TF32 off in the forward AND
    the backward (autograd runs a convolution's backward later, outside
    any context the forward set)."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        with _full_f32_conv():
            return F.conv2d(x, w, b, padding=_PAD)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        with _full_f32_conv():
            gx, gw, gb = torch.ops.aten.convolution_backward(
                gy, x, w, [w.shape[0]], [1, 1], [_PAD, _PAD], [1, 1], False,
                [0, 0], 1, list(ctx.needs_input_grad))
        return gx, gw, gb


class TinyCNN(nn.Module):
    """The TinyCNN over a parameter dict in the reference's layouts: the
    module holds the architecture, the dict the weights (so one module
    serves global, per-client and restored parameters alike)."""

    def __init__(self, num_classes: int = 3, channels=(16, 32),
                 hidden: int = 64, dropout_rate: float = 0.5):
        super().__init__()
        self.num_classes = num_classes
        self.channels = tuple(channels)
        self.hidden = hidden
        self.dropout_rate = dropout_rate

    def forward(self, params: dict, x: torch.Tensor,
                keep: torch.Tensor | None = None) -> torch.Tensor:
        """x [B, H, W] or [B, H, W, C] in [0, 1] → logits [B, K];
        ``keep`` (B, hidden) bools applies dropout."""
        if x.ndim == 3:
            x = x[..., None]
        h = x.permute(0, 3, 1, 2)  # NHWC → NCHW
        for i in range(len(self.channels)):
            conv = params[f"Conv_{i}"]
            h = _Conv5x5.apply(h, conv["kernel"].permute(3, 2, 0, 1),
                               conv["bias"])
            h = F.max_pool2d(F.relu(h), kernel_size=2, stride=2)
        # Back to NHWC: flax flattens (h, w, c).
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        d0, d1 = params["Dense_0"], params["Dense_1"]
        h = F.relu(h @ d0["kernel"] + d0["bias"])
        if keep is not None:
            h = torch.where(keep, h / (1.0 - self.dropout_rate),
                            torch.zeros((), dtype=h.dtype, device=h.device))
        return h @ d1["kernel"] + d1["bias"]


def _lecun_normal(shape, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32)
    nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=gen)
    return t * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)


def make_tiny_cnn(num_classes: int = 3, height: int = 28, width: int = 28,
                  in_channels: int = 1, device=None) -> Model:
    """TinyCNN as a Model on ``device`` (None = the card). Accepts
    [B, H, W] or [B, H, W, C] inputs."""
    module = TinyCNN(num_classes=num_classes)
    dev = pins.resolve_device(device)
    # Two "SAME" convolutions keep H×W; each pool floors it by 2.
    flat = (height // 4) * (width // 4) * module.channels[-1]

    def init(seed) -> dict:
        """flax's defaults: lecun-normal kernels, zero biases. ``seed``
        is an int or a ``torch.Generator``."""
        gen = (seed if isinstance(seed, torch.Generator)
               else torch.Generator().manual_seed(int(seed)))
        shapes, cin = {}, in_channels
        for i, ch in enumerate(module.channels):
            shapes[f"Conv_{i}"] = ((_KERNEL, _KERNEL, cin, ch),
                                   _KERNEL * _KERNEL * cin)
            cin = ch
        shapes["Dense_0"] = ((flat, module.hidden), flat)
        shapes["Dense_1"] = ((module.hidden, num_classes), module.hidden)
        return {
            name: {"kernel": _lecun_normal(shape, fan_in, gen).to(dev),
                   "bias": torch.zeros(shape[-1], dtype=torch.float32,
                                       device=dev)}
            for name, (shape, fan_in) in shapes.items()
        }

    def _features(params, x):
        return torch.as_tensor(x, dtype=torch.float32,
                               device=params["Dense_1"]["bias"].device)

    def apply(params: dict, x) -> torch.Tensor:
        return module(params, _features(params, x))

    def apply_train(params: dict, x, draws: dict) -> torch.Tensor:
        x = _features(params, x)
        return module(params, x, torch.as_tensor(draws["dropout_keep"],
                                                 device=x.device))

    return Model(
        init=init,
        apply=apply,
        apply_train=apply_train,
        train_draws=(StepDraw("dropout_keep", "keep", (module.hidden,),
                              1.0 - module.dropout_rate),),
        name=f"tinycnn{num_classes}c",
    )
