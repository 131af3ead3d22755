"""InceptionV3 pool3 (2048-d) feature extractor of the port (counterpart of
stablediffusioneo_tpu/scoring/inception.py).

The reference scores perceptual distance with pytorch_fid's InceptionV3
activations (compute_score.py:8-17). This is the torchvision inception_v3
tower up to the global pool (the FID feature layer) as an nn.Module under
torchvision's names (the 470 keys of the `pt_inception` universe:
`Conv2d_1a_3x3` ... `Mixed_7c`, each BasicConv2d a `conv` without bias and
a `bn`), with pytorch_fid's variations kept:
  * the branch pools of Mixed_5b-5d, 6b-6e and 7b average 3x3 windows
    without counting the padding (count_include_pad=False);
  * Mixed_7c's branch pool is a 3x3 max pool (stride 1, padding 1);
  * BatchNorm eps 1e-3.
The BatchNorms are ops/layers.py:FrozenBatchNorm2d, which holds no
num_batches_tracked (pt_inception files carry none; a torchvision file's
are documented leftovers, with its AuxLogits head and fc classifier).

`InceptionFeatureExtractor` runs in fp32 on every device, as the JAX tree
is, with TF32 off while it runs: the perceptual distance is a fidelity
measure, not a place for approximation. Preprocessing is pytorch_fid's
contract as the JAX package applies it: cv2.INTER_LINEAR resize of the uint8
image to 299x299 on the host, then the upload and x / 127.5 - 1 on the
device.
"""

from __future__ import annotations

import contextlib
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from stablediffusioneo_tpu_torch.annotators._dtype import default_device
from stablediffusioneo_tpu_torch.ops.layers import FrozenBatchNorm2d

BN_EPS = 1e-3
SIDE = 299
# leftovers of a full torchvision inception_v3 file: BatchNorm momentum
# counters, the training-time auxiliary classifier and the fc head
INCEPTION_LEFTOVERS = (r".*\.bn\.num_batches_tracked", r"AuxLogits\..*", r"fc\.(weight|bias)")


class BasicConv2d(nn.Module):
    """conv (no bias) + BatchNorm (eps 1e-3) + ReLU."""

    def __init__(self, cin: int, cout: int, k, stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=False)
        self.bn = FrozenBatchNorm2d(cout, BN_EPS)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_nocount(x):
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _max_pool(x):
    return F.max_pool2d(x, 3, 2)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), self.branch5x5_2(self.branch5x5_1(x)), b3,
                          self.branch_pool(_avg_pool_nocount(x))], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_avg_pool_nocount(x))], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b7 = self.branch7x7x3_1(x)
        for i in range(2, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7, _max_pool(x)], dim=1)


class InceptionE(nn.Module):
    """pool "avg": Mixed_7b's branch pool (count_include_pad=False); "max":
    pytorch_fid's Mixed_7c."""

    def __init__(self, cin: int, pool: str):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        pooled = (F.max_pool2d(x, 3, 1, 1) if self.pool == "max" else _avg_pool_nocount(x))
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(pooled)], dim=1)


class FIDInceptionV3(nn.Module):
    """x (N, 3, 299, 299) in [-1, 1] -> (N, 2048) pool3 features."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")

    def forward(self, x):
        h = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        h = _max_pool(h)
        h = _max_pool(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(h)))
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            h = getattr(self, name)(h)
        return h.mean(dim=(2, 3))  # global average pool


def init_inception(generator: Optional[torch.Generator] = None) -> FIDInceptionV3:
    """The tower with weights drawn from `generator` (default seed 0;
    BatchNorms at identity), on the generator's device."""
    from stablediffusioneo_tpu_torch.models.cldm import init_weights

    generator = generator or torch.Generator().manual_seed(0)
    with torch.device(generator.device):
        net = FIDInceptionV3()
    init_weights(net, generator)
    return net


@contextlib.contextmanager
def no_tf32():
    """TF32 off for matmuls and cuDNN convs inside the block, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class InceptionFeatureExtractor:
    """Extractor for scoring.perceptual_distance: uint8 HWC image -> (2048,)
    float32 activations, pytorch_fid preprocessing. params: a state dict
    under torchvision's names; ckpt_path: a pt_inception or torchvision
    inception_v3 file (a nested `state_dict` unwrapped); both loaded with
    strict accounting (INCEPTION_LEFTOVERS ignored). device: the card unless
    the caller names another; fp32 there too."""

    def __init__(self, params: Optional[Mapping] = None, ckpt_path: Optional[str] = None,
                 device=None):
        from stablediffusioneo_tpu_torch.checkpoint.accounting import load_strict
        from stablediffusioneo_tpu_torch.checkpoint.torch_reader import load_torch_state_dict

        if params is None and ckpt_path is not None:
            params = load_torch_state_dict(ckpt_path)
        if params is None:
            raise ValueError("InceptionFeatureExtractor needs params or ckpt_path")
        self.device = default_device(device)
        net = FIDInceptionV3()
        self.report = load_strict(net, params, "inception", ignore=INCEPTION_LEFTOVERS)
        self.net = net.to(device=self.device, dtype=torch.float32).eval().requires_grad_(False)

    @torch.no_grad()
    def features(self, u8: torch.Tensor) -> torch.Tensor:
        """(N, 299, 299, 3) uint8 on the device -> (N, 2048) fp32."""
        x = u8.float() / 127.5 - 1.0
        with no_tf32():
            return self.net(x.permute(0, 3, 1, 2))

    def __call__(self, img: np.ndarray) -> np.ndarray:
        import cv2

        x = cv2.resize(img, (SIDE, SIDE), interpolation=cv2.INTER_LINEAR)
        u8 = torch.from_numpy(np.ascontiguousarray(x[None])).to(self.device)
        return self.features(u8)[0].cpu().numpy()
