"""The port's CUDA kernels against their plain versions, on a CUDA card.

Every test here needs an NVIDIA card and nvcc (the kernels are built for
sm_90a, at first use) and skips without one, from the ``device`` fixture.
The file imports no JAX, so that it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: none. The kernels compute the same float32 operations as their
plain versions, or select input values, so they must agree bit for bit
and the window index exactly. These cases add to chip_smoke.py's served
shapes the odd ones: rows whose length is not a multiple of the crop's
vector width, low padding, VALID tails, bf16 ties.
"""

import pytest
import torch

from tensor2robot_tpu_torch import kernels
from tensor2robot_tpu_torch.layers import pooling
from tensor2robot_tpu_torch.preprocessors import pallas_crop

POOL_CASES = [
    ((2, 35, 35, 8), 3, 'SAME'),
    ((1, 27, 27, 8), 2, 'SAME'),
    ((2, 24, 24, 8), 2, 'VALID'),
    ((1, 29, 31, 8), 3, 'VALID'),
    ((2, 25, 25, 8), 3, 'SAME'),      # low padding
    ((3, 13, 9, 5), 2, 'SAME'),
    ((2, 79, 79, 64), 3, 'SAME'),     # the served 79 -> 27 pool
]


@pytest.fixture
def device():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA card and nvcc; the kernels are built for '
                'sm_90a')
  return torch.device('cuda')


def _generator(device, seed):
  return torch.Generator(device=device).manual_seed(seed)


@pytest.mark.parametrize('out_dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape,target', [
    ((8, 512, 640, 3), (472, 472)),   # served; vector stores
    ((3, 20, 25, 3), (7, 9)),         # row of 27: scalar tail
    ((2, 9, 11, 1), (9, 11)),         # whole frame
])
def test_crop_convert_matches_plain(device, shape, target, out_dtype):
  gen = _generator(device, 0)
  b, h, w, _ = shape
  images = torch.randint(0, 256, shape, dtype=torch.uint8, device=device,
                         generator=gen)
  offsets = torch.stack([
      torch.randint(-3, h - target[0] + 4, (b,), device=device,
                    generator=gen),
      torch.randint(-3, w - target[1] + 4, (b,), device=device,
                    generator=gen)], -1).to(torch.int32)
  before = kernels.LAUNCHES['crop_convert']
  got = pallas_crop.crop_convert(images, offsets, target, out_dtype)
  assert kernels.LAUNCHES['crop_convert'] == before + 1
  want = pallas_crop.crop_convert_plain(images, offsets, target, out_dtype)
  torch.cuda.synchronize()
  assert got.dtype == out_dtype and got.shape == want.shape
  assert torch.equal(got, want)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape,k,padding', POOL_CASES)
def test_max_pool_matches_plain(device, shape, k, padding, dtype):
  x = torch.randn(shape, device=device, generator=_generator(device, 1))
  if dtype == torch.bfloat16:
    x = torch.round(x * 2)   # exact ties inside windows
  x = x.to(dtype)
  before = kernels.LAUNCHES['max_pool']
  got, idx = pooling.max_pool(x, (k, k), (k, k), padding, True)
  values = pooling.max_pool(x, (k, k), (k, k), padding)
  assert kernels.LAUNCHES['max_pool'] == before + 2
  want, want_idx = pooling.max_pool_plain(x, (k, k), (k, k), padding, True)
  torch.cuda.synchronize()
  assert torch.equal(got, want) and torch.equal(values, want)
  assert torch.equal(idx, want_idx)


def test_kernels_refuse_what_they_do_not_take(device):
  x = torch.randn(2, 9, 9, 4, device=device)
  with pytest.raises(ValueError, match='contiguous'):
    pooling.max_pool(x.transpose(1, 2), (3, 3), (3, 3), 'SAME')
  with pytest.raises(ValueError, match='float32 or bfloat16'):
    pooling.max_pool(x.half(), (3, 3), (3, 3), 'SAME')
  images = torch.zeros(2, 16, 20, 3, dtype=torch.uint8, device=device)
  with pytest.raises(ValueError, match='contiguous'):
    pallas_crop.crop_convert(images.transpose(1, 2), torch.zeros(
        2, 2, dtype=torch.int32), (8, 8))
