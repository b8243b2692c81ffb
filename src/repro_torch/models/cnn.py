"""The paper's three MXNet image-classification models, in PyTorch:

  * SqueezeNet v1.0  (arXiv:1602.07360)  — ~5 MB of weights
  * ResNet-18        (arXiv:1512.03385)  — ~45 MB
  * ResNeXt-50 32x4d (arXiv:1611.05431)  — ~98 MB

The counterpart of ``repro.models.cnn``: the serverless payloads whose
forward passes ``repro_torch.core.calibration`` times, as the paper times
MXNet predictions inside Lambda.  BatchNorm is folded to inference-mode
scale/shift (the paper only serves).

Images are NCHW and conv weights OIHW, PyTorch's layouts (the reference
keeps NHWC and HWIO; ``convert.from_reference`` permutes its weights).  The
convolutions are ``F.conv2d`` (cuDNN on the card), as the reference leaves
them to XLA's ``conv_general_dilated``: this path reaches no Pallas kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import resolve_device

from .common import ModelConfig


def _conv_init(gen, kh, kw, cin, cout, device):
    w = torch.randn((cout, cin, kh, kw), generator=gen, device=device,
                    dtype=torch.float32)
    return w * math.sqrt(2.0 / (kh * kw * cin))


def same_pad(n: int, k: int, s: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial axis of length ``n``: the output
    has ceil(n/s) positions, and an odd total goes to the high side.  At
    stride 2 it depends on ``n`` (7x7/2 at 224: (2, 3); at 57: (3, 3))."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv2d(w, x, stride=1, padding="SAME", groups=1):
    """x: (N, C, H, W), w: (O, C/groups, kh, kw).  ``padding`` is "SAME"
    (XLA's, computed from this call's H and W) or "VALID"."""
    if padding == "SAME":
        (top, bottom), (left, right) = (same_pad(n, k, stride)
                                        for n, k in zip(x.shape[2:], w.shape[2:]))
        if top != bottom or left != right:
            x = F.pad(x, (left, right, top, bottom))
        else:
            return F.conv2d(x, w, stride=stride, padding=(top, left), groups=groups)
    return F.conv2d(x, w, stride=stride, groups=groups)


def _bn_init(c, device):
    return {"scale": torch.ones((c,), dtype=torch.float32, device=device),
            "bias": torch.zeros((c,), dtype=torch.float32, device=device)}


def bn(p, x):
    return x * p["scale"][:, None, None] + p["bias"][:, None, None]


def maxpool(x, k, s, pad=0):
    """Max over k x k windows at stride s.  ``pad`` pads with -inf, which
    gives the reference's zero pad's maxima wherever x >= 0 (after a ReLU)."""
    return F.max_pool2d(x, k, s, padding=pad)


def avgpool_global(x):
    return x.mean(dim=(2, 3))


# ======================================================================
# SqueezeNet v1.0
# ======================================================================

_FIRE = [  # (squeeze, expand1x1, expand3x3) per fire module; pool after idx 2,6
    (16, 64, 64), (16, 64, 64), (32, 128, 128), (32, 128, 128),
    (48, 192, 192), (48, 192, 192), (64, 256, 256), (64, 256, 256),
]


def squeezenet_init(gen, num_classes, device):
    p = {"conv1": _conv_init(gen, 7, 7, 3, 96, device)}
    cin = 96
    fires = []
    for (sq, e1, e3) in _FIRE:
        fires.append({
            "squeeze": _conv_init(gen, 1, 1, cin, sq, device),
            "e1": _conv_init(gen, 1, 1, sq, e1, device),
            "e3": _conv_init(gen, 3, 3, sq, e3, device),
        })
        cin = e1 + e3
    p["fires"] = fires
    p["conv_final"] = _conv_init(gen, 1, 1, cin, num_classes, device)
    return p


def _fire(p, x):
    s = F.relu(conv2d(p["squeeze"], x))
    return torch.cat([F.relu(conv2d(p["e1"], s)), F.relu(conv2d(p["e3"], s))], dim=1)


def squeezenet_forward(p, images):
    x = F.relu(conv2d(p["conv1"], images, stride=2, padding="VALID"))
    x = maxpool(x, 3, 2)
    for i, f in enumerate(p["fires"]):
        x = _fire(f, x)
        if i in (2, 6):
            x = maxpool(x, 3, 2)
    x = F.relu(conv2d(p["conv_final"], x))
    return avgpool_global(x)


# ======================================================================
# ResNet-18 / ResNeXt-50
# ======================================================================

def _stem(p, images):
    x = F.relu(bn(p["bn1"], conv2d(p["conv1"], images, stride=2)))
    return maxpool(x, 3, 2, pad=1)


def _strides(blocks_per_stage):
    return [2 if (stage > 0 and b == 0) else 1
            for stage, n in enumerate(blocks_per_stage) for b in range(n)]


def _fc_init(gen, d, num_classes, device):
    return {"w": torch.randn((d, num_classes), generator=gen, device=device,
                             dtype=torch.float32) / math.sqrt(d)}


def _basic_block_init(gen, cin, cout, stride, device):
    p = {"conv1": _conv_init(gen, 3, 3, cin, cout, device), "bn1": _bn_init(cout, device),
         "conv2": _conv_init(gen, 3, 3, cout, cout, device), "bn2": _bn_init(cout, device)}
    if stride != 1 or cin != cout:
        p["proj"] = _conv_init(gen, 1, 1, cin, cout, device)
        p["bnp"] = _bn_init(cout, device)
    return p


def _basic_block(p, x, s):
    y = F.relu(bn(p["bn1"], conv2d(p["conv1"], x, stride=s)))
    y = bn(p["bn2"], conv2d(p["conv2"], y))
    sc = bn(p["bnp"], conv2d(p["proj"], x, stride=s)) if "proj" in p else x
    return F.relu(y + sc)


_RESNET18_STAGES = [(64, 2), (128, 2), (256, 2), (512, 2)]   # (channels, blocks)


def resnet18_init(gen, num_classes, device):
    p = {"conv1": _conv_init(gen, 7, 7, 3, 64, device), "bn1": _bn_init(64, device)}
    blocks, cin = [], 64
    strides = iter(_strides([n for _, n in _RESNET18_STAGES]))
    for cout, n in _RESNET18_STAGES:
        for _ in range(n):
            blocks.append(_basic_block_init(gen, cin, cout, next(strides), device))
            cin = cout
    p["blocks"] = blocks
    p["fc"] = _fc_init(gen, 512, num_classes, device)
    return p


def resnet18_forward(p, images):
    x = _stem(p, images)
    for b, s in zip(p["blocks"], _strides([n for _, n in _RESNET18_STAGES])):
        x = _basic_block(b, x, s)
    return avgpool_global(x) @ p["fc"]["w"]


def _resnext_block_init(gen, cin, cmid, cout, stride, device, groups=32):
    p = {"conv1": _conv_init(gen, 1, 1, cin, cmid, device), "bn1": _bn_init(cmid, device),
         "conv2": _conv_init(gen, 3, 3, cmid // groups, cmid, device),
         "bn2": _bn_init(cmid, device),
         "conv3": _conv_init(gen, 1, 1, cmid, cout, device), "bn3": _bn_init(cout, device)}
    if stride != 1 or cin != cout:
        p["proj"] = _conv_init(gen, 1, 1, cin, cout, device)
        p["bnp"] = _bn_init(cout, device)
    return p


def _resnext_block(p, x, s, g=32):
    y = F.relu(bn(p["bn1"], conv2d(p["conv1"], x)))
    y = F.relu(bn(p["bn2"], conv2d(p["conv2"], y, stride=s, groups=g)))
    y = bn(p["bn3"], conv2d(p["conv3"], y))
    sc = bn(p["bnp"], conv2d(p["proj"], x, stride=s)) if "proj" in p else x
    return F.relu(y + sc)


_RESNEXT50_STAGES = [(128, 256, 3), (256, 512, 4), (512, 1024, 6), (1024, 2048, 3)]


def resnext50_init(gen, num_classes, device):
    p = {"conv1": _conv_init(gen, 7, 7, 3, 64, device), "bn1": _bn_init(64, device)}
    blocks, cin = [], 64
    strides = iter(_strides([n for _, _, n in _RESNEXT50_STAGES]))
    for cmid, cout, n in _RESNEXT50_STAGES:
        for _ in range(n):
            blocks.append(_resnext_block_init(gen, cin, cmid, cout, next(strides), device))
            cin = cout
    p["blocks"] = blocks
    p["fc"] = _fc_init(gen, 2048, num_classes, device)
    return p


def resnext50_forward(p, images):
    x = _stem(p, images)
    for b, s in zip(p["blocks"], _strides([n for _, _, n in _RESNEXT50_STAGES])):
        x = _resnext_block(b, x, s)
    return avgpool_global(x) @ p["fc"]["w"]


# ======================================================================
# unified API
# ======================================================================

_VARIANTS = {
    "squeezenet": (squeezenet_init, squeezenet_forward),
    "resnet18": (resnet18_init, resnet18_forward),
    "resnext50": (resnext50_init, resnext50_forward),
}


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda") -> dict:
    """Random float32 weights with the reference's distributions, drawn
    from ``generator`` on ``device``: the card unless the caller asks for
    the CPU; raises when the card is asked for and there is none."""
    init, _ = _VARIANTS[cfg.cnn_variant]
    return init(generator, cfg.num_classes, resolve_device(device))


def forward(params, images, cfg: ModelConfig):
    """images: (N, 3, H, W) float32 -> (N, num_classes) logits."""
    _, fwd = _VARIANTS[cfg.cnn_variant]
    return fwd(params, images)


def predict(params, images, cfg: ModelConfig):
    """The paper's Lambda handler body: forward pass -> class id."""
    return torch.argmax(forward(params, images, cfg), dim=-1)
