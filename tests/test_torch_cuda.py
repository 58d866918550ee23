"""The port's CUDA kernels against their plain versions, on a CUDA card.

Every test here needs an NVIDIA card and nvcc (the kernels are built for
sm_90a, at first use): each carries the ``cuda`` marker and skips without a
card, from the ``device`` fixture.
The file imports no JAX, so that it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: none for K1, K2f and K2b. They compute the same float32
operations as their plain versions, or select or route input values, so
they must agree bit for bit and the window index exactly. K3 sums some 10^3
to 10^5 float32-grade (3xTF32) products per output in another order than
its plain version's matrix products: it must agree within 1e-4 of
max|plain|. These cases add to chip_smoke.py's shapes the odd ones: rows
whose length is not a multiple of the crop's vector width, low padding,
VALID tails, bf16 ties, channel counts of 32, 36 and 128 (not one 64-channel
tile), rows that are not a multiple of K3's 80-position segment.
K4 (flash attention, float32-grade 3xTF32 products on the tensor cores)
sums its products and softmax in another order than its dense plain
version: O within 1e-5 in float32 and 2e-2 (one rounding of values of
order 1) in bfloat16, LSE within 1e-5, and the same bits run to run; its
cases add lengths that are not a multiple of its 64-row tiles, head dim
128 and several batches and heads. K2b's cases also take its one-element
instance (C = 5, a dy one element off 16 bytes) and VALID tails, which no
window covers and which it must zero. K5a and K5b (the flash attention backward) sum their
products in another order than the dense plain backward (K5a in 3xTF32 on
the tensor cores): dq, dk and dv within 1e-4 of each one's max|plain| in
float32 and 2e-2 of it (one bf16 rounding of the result) in bfloat16, at
ragged lengths, head dim 128, Lq != Lk and lengths one past or one short
of K5a's 32-query and 64-key tiles and of K5b's 64-query block and 32-key
tiles, causal and not. K2f's cases also take each of its instances: 16-byte
vectors of 4, 8, 12 and 64 float32 or 8 and 16 bf16 channels, one channel
at a time for 5 (and 12 in bf16), windows of 2, 3 and 4, and NaN and
exact ties, whose value bits and index must match. K6 (the ring hop) sums in another order than
its dense plain version: the carried o, m and l within 1e-5 of each one's
max, at ragged tiles, head dim 128, Lq != Lk, global offsets that cross the
diagonal, a hop the causal mask hides (which must leave the state as it
was, bit for bit) and a carried state as well as the initial one.
"""

import pytest
import torch

from tensor2robot_tpu_torch import kernels
from tensor2robot_tpu_torch.layers import pooling
from tensor2robot_tpu_torch.layers import wgrad
from tensor2robot_tpu_torch.parallel import flash_attention
from tensor2robot_tpu_torch.preprocessors import pallas_crop

pytestmark = pytest.mark.cuda

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


# K2f's instances: 16-byte vectors (4 float32, 8 bf16 channels) where C
# allows them, one channel otherwise (C = 5, and 12 in bf16); the 3x3 and
# 2x2 windows load a whole window before comparing, 4x4 loops.
@pytest.mark.parametrize('dtype,channels', [
    (torch.float32, 4), (torch.float32, 8), (torch.float32, 12),
    (torch.float32, 64), (torch.float32, 5), (torch.bfloat16, 8),
    (torch.bfloat16, 16), (torch.bfloat16, 12), (torch.bfloat16, 5),
])
@pytest.mark.parametrize('spatial,k,padding', [
    ((2, 25, 25), 3, 'SAME'),     # low padding
    ((3, 13, 9), 2, 'SAME'),
    ((2, 22, 21), 4, 'VALID'),
])
def test_max_pool_vector_widths_match_plain(device, dtype, channels, spatial,
                                            k, padding):
  shape = spatial + (channels,)
  x = torch.randn(shape, device=device, generator=_generator(device, 7))
  x = torch.round(x * 2).to(dtype)   # exact ties inside windows
  before = kernels.LAUNCHES['max_pool']
  got, idx = pooling.max_pool(x, (k, k), (k, k), padding, True)
  values = pooling.max_pool(x, (k, k), (k, k), padding)
  assert kernels.LAUNCHES['max_pool'] == before + 2
  want, want_idx = pooling.max_pool_plain(x, (k, k), (k, k), padding, True)
  torch.cuda.synchronize()
  assert torch.equal(got, want) and torch.equal(values, want)
  assert torch.equal(idx, want_idx)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('channels', [8, 5])
def test_max_pool_nan_and_ties_match_plain(device, dtype, channels):
  """NaN is maximal and the first NaN wins; among equal maxima the first
  row of a column, then the first column: value bits and index exact."""
  x = torch.zeros(2, 9, 9, channels, device=device)
  x[0, 0, 0, 0] = float('nan')          # a NaN in the first cell
  x[0, 1, 1, 0] = float('nan')          # and a later one in the window
  x[0, 4, 5, 1] = float('nan')          # a lone NaN past the first cell
  x[1, 4, 4, :] = 1.0                   # a tie across columns and rows
  x[1, 3, 5, :] = 1.0
  x[1, 5, 3, :] = 1.0
  x[1, 7:, 6:, :] = -1.0                # a window with no zero
  x = x.to(dtype)
  got, idx = pooling.max_pool(x, (3, 3), (3, 3), 'SAME', True)
  want, want_idx = pooling.max_pool_plain(x, (3, 3), (3, 3), 'SAME', True)
  torch.cuda.synchronize()
  bits = torch.int32 if dtype == torch.float32 else torch.int16
  assert torch.equal(got.view(bits), want.view(bits))
  assert torch.equal(idx, want_idx)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', [(2, 9, 9, 0), (0, 9, 9, 8)])
def test_max_pool_of_an_empty_map_is_empty(device, dtype, shape):
  x = torch.zeros(shape, device=device, dtype=dtype)
  before = kernels.LAUNCHES['max_pool']
  got, idx = pooling.max_pool(x, (3, 3), (3, 3), 'SAME', True)
  assert kernels.LAUNCHES['max_pool'] == before   # nothing to launch
  want, want_idx = pooling.max_pool_plain(x, (3, 3), (3, 3), 'SAME', True)
  assert got.shape == want.shape and idx.shape == want_idx.shape
  assert got.dtype == dtype and idx.dtype == torch.int8


def test_kernels_refuse_what_they_do_not_take(device):
  x = torch.randn(2, 9, 9, 4, device=device)
  with pytest.raises(ValueError, match='multiple of 4'):
    wgrad.conv5x5_wgrad(x[..., :3].contiguous(), x[..., :3].contiguous())
  with pytest.raises(ValueError, match='contiguous'):
    wgrad.conv5x5_wgrad(x.transpose(1, 2), x.transpose(1, 2))
  with pytest.raises(ValueError, match='contiguous'):
    pooling.max_pool(x.transpose(1, 2), (3, 3), (3, 3), 'SAME')
  with pytest.raises(ValueError, match='float32 or bfloat16'):
    pooling.max_pool(x.half(), (3, 3), (3, 3), 'SAME')
  images = torch.zeros(2, 16, 20, 3, dtype=torch.uint8, device=device)
  with pytest.raises(ValueError, match='contiguous'):
    pallas_crop.crop_convert(images.transpose(1, 2), torch.zeros(
        2, 2, dtype=torch.int32), (8, 8))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape,k,padding', POOL_CASES)
def test_max_pool_backward_matches_plain(device, shape, k, padding, dtype):
  gen = _generator(device, 2)
  x = torch.randn(shape, device=device, generator=gen)
  if dtype == torch.bfloat16:
    x = torch.round(x * 2)   # exact ties inside windows
  x = x.to(dtype)
  _, idx = pooling.max_pool_forward(x, (k, k), (k, k), padding, True)
  dy = torch.randn(idx.shape, device=device, generator=gen).to(dtype)
  before = kernels.LAUNCHES['max_pool_backward']
  got = pooling.max_pool_backward(dy, idx, shape, (k, k), padding)
  assert kernels.LAUNCHES['max_pool_backward'] == before + 1
  want = pooling.max_pool_backward_plain(dy, idx, shape, (k, k), padding)
  torch.cuda.synchronize()
  assert got.dtype == dtype and got.shape == want.shape
  assert torch.equal(got, want)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape,k,padding,dy_offset,width', [
    ((3, 13, 9, 5), 2, 'SAME', 0, 1),     # C = 5: the one-element instance
    ((2, 79, 79, 64), 3, 'SAME', 1, 1),   # dy one element off 16 bytes
    ((2, 29, 31, 64), 3, 'VALID', 0, 0),  # vectors; a tail row and column
    ((2, 35, 34, 16), 4, 'VALID', 0, 0),  # a runtime window; 3 + 2 tails
    ((1, 29, 31, 5), 3, 'VALID', 0, 1),   # a tail, one element at a time
])
def test_max_pool_backward_instances_match_plain(device, shape, k, padding,
                                                 dy_offset, width, dtype):
  """K2b's vector and one-element instances, and the VALID tail that no
  window covers, bit for bit (width 0: 16 bytes' worth)."""
  gen = _generator(device, 7)
  x = torch.randn(shape, device=device, generator=gen).to(dtype)
  _, idx = pooling.max_pool_forward(x, (k, k), (k, k), padding, True)
  storage = torch.randn(idx.numel() + 8, device=device,
                        generator=gen).to(dtype)
  dy = storage[dy_offset:dy_offset + idx.numel()].view(idx.shape)
  assert pooling.vector_width(dy, idx) == (width or 16 // dy.element_size())
  before = kernels.LAUNCHES['max_pool_backward']
  got = pooling.max_pool_backward(dy, idx, shape, (k, k), padding)
  assert kernels.LAUNCHES['max_pool_backward'] == before + 1
  want = pooling.max_pool_backward_plain(dy, idx, shape, (k, k), padding)
  torch.cuda.synchronize()
  bits = torch.int32 if dtype == torch.float32 else torch.int16
  assert got.dtype == dtype and got.shape == want.shape
  assert torch.equal(got.view(bits), want.view(bits))


def test_max_pool_autograd_launches_both_kernels(device):
  x = torch.randn(2, 25, 25, 8, device=device, requires_grad=True)
  before = dict(kernels.LAUNCHES)
  out = pooling.max_pool(x, (3, 3), (3, 3), 'SAME')
  (out * out).sum().backward()
  assert kernels.LAUNCHES['max_pool'] == before['max_pool'] + 1
  assert (kernels.LAUNCHES['max_pool_backward'] ==
          before['max_pool_backward'] + 1)
  xp = x.detach().cpu().requires_grad_()
  ref = pooling.max_pool(xp, (3, 3), (3, 3), 'SAME')
  (ref * ref).sum().backward()
  assert torch.equal(x.grad.cpu(), xp.grad)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', [
    (4, 19, 23, 64),     # tests/test_layers.py TestPallasWgrad's shape
    (3, 7, 11, 36),      # a partial channel tile
    (1, 5, 4, 8),        # smaller than the kernel's reach
    (2, 79, 79, 64),     # the body convs' map
    (3, 9, 13, 32),      # C = 32: half a channel tile
    (2, 30, 170, 128),   # C = 128: 2 x 2 tiles; rows of 2 segments + 10
    (1, 3, 81, 64),      # a row one past the 80-position segment
])
def test_conv5x5_wgrad_matches_plain(device, shape, dtype):
  gen = _generator(device, 3)
  x = torch.randn(shape, device=device, generator=gen).to(dtype)
  dy = torch.randn(shape, device=device, generator=gen).to(dtype)
  before = kernels.LAUNCHES['conv5x5_wgrad']
  got = wgrad.conv5x5_wgrad(x, dy)
  assert kernels.LAUNCHES['conv5x5_wgrad'] == before + 1
  want = wgrad.conv5x5_wgrad_plain(x, dy)
  torch.cuda.synchronize()
  assert got.dtype == torch.float32 and got.shape == (5, 5) + shape[3:] * 2
  err = float((got - want).abs().max())
  assert err <= 1e-4 * float(want.abs().max()), err
  # The same inputs give the same bits: the partial sums are reduced in a
  # fixed order.
  assert torch.equal(wgrad.conv5x5_wgrad(x, dy), got)


FLASH_ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('b,l,h,d', [
    (2, 200, 3, 64),     # ragged last tile
    (1, 72, 2, 128),     # head dim 128
    (3, 8, 1, 64),       # shorter than one tile
    (1, 1024, 4, 64),
])
def test_flash_attention_matches_plain(device, b, l, h, d, causal, dtype):
  gen = _generator(device, 4)
  qkv = torch.randn((b, l, h, 3, d), device=device, generator=gen).to(dtype)
  q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
  bhld = [x.permute(0, 2, 1, 3).reshape(b * h, l, d) for x in (q, k, v)]
  before = kernels.LAUNCHES['flash_attention_fwd']
  got = flash_attention.flash_attention(q, k, v, causal=causal)
  got_o, got_lse = flash_attention.flash_attention_with_lse(*bhld,
                                                            causal=causal)
  assert kernels.LAUNCHES['flash_attention_fwd'] == before + 2
  want_o, want_lse = flash_attention.flash_attention_plain(
      *bhld, causal, 1.0 / d ** 0.5)
  torch.cuda.synchronize()
  assert got.dtype == dtype and got.shape == (b, l, h, d)
  assert got_lse.dtype == torch.float32 and got_lse.shape == (b * h, l)
  blhd = want_o.reshape(b, h, l, d).permute(0, 2, 1, 3)
  assert float((got.float() - blhd.float()).abs().max()) <= FLASH_ATOL[dtype]
  assert float((got_o.float() - want_o.float()).abs().max()) <= (
      FLASH_ATOL[dtype])
  assert float((got_lse - want_lse).abs().max()) <= 1e-5


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_flash_attention_is_the_same_bits_run_to_run(device, dtype):
  """K4 sums in a fixed order: the same inputs give the same O and LSE."""
  gen = _generator(device, 8)
  qkv = torch.randn((1, 1024, 4, 3, 64), device=device, generator=gen).to(
      dtype)
  q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
  out, lse = flash_attention.flash_attention_forward(q, k, v, True, 0.125)
  again = flash_attention.flash_attention_forward(q, k, v, True, 0.125)
  torch.cuda.synchronize()
  assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


def test_flash_attention_fwd_refuses_unaligned_rows(device):
  """K4 copies rows 4 elements at a time: a view whose rows do not start
  on 16 bytes raises instead of reading them."""
  base = torch.randn(1 + 64 * 2 * 64, device=device)
  q = base[1:].view(1, 64, 2, 64)        # 4 bytes past an aligned start
  k = torch.randn(1, 64, 2, 64, device=device)
  before = kernels.LAUNCHES['flash_attention_fwd']
  for args in ((q, k, k), (k, q, k), (k, k, q)):
    with pytest.raises(ValueError, match='16-byte aligned'):
      flash_attention.flash_attention_forward(*args, True, 0.125)
  assert kernels.LAUNCHES['flash_attention_fwd'] == before


def test_flash_attention_refuses_what_it_does_not_take(device):
  x = torch.randn(1, 64, 2, 32, device=device)
  with pytest.raises(ValueError, match='head dims'):
    flash_attention.flash_attention(x, x, x)
  y = torch.randn(1, 64, 2, 64, device=device)
  with pytest.raises(ValueError, match='float32 or bfloat16'):
    flash_attention.flash_attention(y.half(), y.half(), y.half())
  with pytest.raises(ValueError, match='unit stride'):
    t = y.transpose(-1, -2).contiguous().transpose(-1, -2)
    flash_attention.flash_attention(t, t, t)
  with pytest.raises(ValueError, match='multiple of 8'):
    z = torch.randn(1, 100, 2, 64, device=device)
    flash_attention.flash_attention(z, z, z)


BWD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('b,l_q,l_k,h,d', [
    (2, 200, 200, 3, 64),    # ragged last tile
    (1, 72, 136, 2, 128),    # head dim 128, Lq < Lk
    (1, 130, 70, 2, 64),     # Lq > Lk: causal key tiles past the queries
    (3, 8, 8, 1, 64),        # shorter than one tile
    (1, 1024, 1024, 4, 64),
    (1, 33, 65, 2, 64),      # one past a 32-query tile and a 64-key tile
    (2, 96, 160, 2, 128),    # D = 128; 3 query tiles, 2.5 key tiles
    (1, 191, 63, 2, 128),    # Lq > Lk, both one short of a tile
    # One past K5b's 64-query block; around its 32-key tile.
    (1, 65, 31, 2, 64),
    (1, 65, 33, 2, 128),
    (1, 65, 97, 2, 64),
    (1, 129, 31, 2, 128),
    (1, 129, 33, 2, 64),
    (1, 129, 97, 2, 128),
])
def test_flash_attention_backward_matches_plain(device, b, l_q, l_k, h, d,
                                                causal, dtype):
  gen = _generator(device, 5)
  qkv = torch.randn((b, l_k, h, 3, d), device=device, generator=gen).to(
      dtype)
  q = torch.randn((b, l_q, h, d), device=device, generator=gen).to(dtype)
  k, v = qkv[..., 1, :], qkv[..., 2, :]
  scale = 1.0 / d ** 0.5
  out, lse = flash_attention.flash_attention_forward(q, k, v, causal, scale)
  d_out = torch.randn(out.shape, device=device, generator=gen).to(dtype)
  before = dict(kernels.LAUNCHES)
  got = flash_attention.flash_attention_backward(q, k, v, out, lse, d_out,
                                                 causal, scale)
  assert kernels.LAUNCHES['flash_attention_bwd_kv'] == (
      before['flash_attention_bwd_kv'] + 1)
  assert kernels.LAUNCHES['flash_attention_bwd_q'] == (
      before['flash_attention_bwd_q'] + 1)
  want = flash_attention.flash_attention_bwd_plain_blhd(
      q, k, v, out, lse, d_out, causal, scale)
  torch.cuda.synchronize()
  for name, g, w in zip(('dq', 'dk', 'dv'), got, want):
    assert g.dtype == dtype and g.shape == w.shape, name
    assert g.is_contiguous(), name
    err = float((g.float() - w.float()).abs().max())
    assert err <= BWD_RTOL[dtype] * float(w.float().abs().max()), (name, err)
  # A fixed summation order: the same bits from run to run.
  again = flash_attention.flash_attention_backward(q, k, v, out, lse, d_out,
                                                   causal, scale)
  assert all(torch.equal(x, y) for x, y in zip(got, again))


def test_flash_attention_bwd_kv_refuses_unaligned_rows(device):
  """K5a copies rows 4 elements at a time: a view whose rows do not start
  on 16 bytes raises instead of reading them."""
  base = torch.randn(1 + 64 * 2 * 64, device=device)
  q = base[1:].view(1, 64, 2, 64)        # 4 bytes past an aligned start
  k = torch.randn(1, 64, 2, 64, device=device)
  lse = torch.zeros(1, 2, 64, device=device)
  with pytest.raises(ValueError, match='16-byte aligned'):
    flash_attention.flash_attention_bwd_kv(q, k, k, k, lse, lse, True, 0.125)


def test_flash_attention_bwd_q_refuses_unaligned_rows(device):
  """K5b copies rows 4 elements at a time too: a view whose rows do not
  start on 16 bytes raises instead of reading them."""
  base = torch.randn(1 + 64 * 2 * 64, device=device)
  q = base[1:].view(1, 64, 2, 64)        # 4 bytes past an aligned start
  k = torch.randn(1, 64, 2, 64, device=device)
  lse = torch.zeros(1, 2, 64, device=device)
  with pytest.raises(ValueError, match='16-byte aligned'):
    flash_attention.flash_attention_bwd_q(q, k, k, k, lse, lse, True, 0.125)
  with pytest.raises(ValueError, match='16-byte aligned'):
    flash_attention.flash_attention_bwd_q(k, q, k, k, lse, lse, True, 0.125)


def test_flash_attention_autograd_launches_k4_k5a_k5b(device):
  gen = _generator(device, 6)
  qkv = torch.randn((2, 136, 2, 3, 64), device=device, generator=gen)
  qkv.requires_grad_()
  before = dict(kernels.LAUNCHES)
  out = flash_attention.flash_attention(qkv[..., 0, :], qkv[..., 1, :],
                                        qkv[..., 2, :], causal=True)
  (out * (1 + 0.01 * out)).sum().backward()
  for name in ('flash_attention_fwd', 'flash_attention_bwd_kv',
               'flash_attention_bwd_q'):
    assert kernels.LAUNCHES[name] == before[name] + 1, name
  ref = qkv.detach().cpu().requires_grad_()
  out_cpu = flash_attention.flash_attention(ref[..., 0, :], ref[..., 1, :],
                                            ref[..., 2, :], causal=True)
  (out_cpu * (1 + 0.01 * out_cpu)).sum().backward()
  err = float((qkv.grad.cpu() - ref.grad).abs().max())
  assert err <= 1e-4 * float(ref.grad.abs().max()), err


CARRY_RTOL = 1e-5   # of max|plain|, for o, m and l


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('b,l_q,l_k,h,d,q_offset,k_offset,causal,carried', [
    (2, 100, 72, 3, 128, 40, 30, True, True),    # ragged, crosses the diagonal
    (2, 100, 72, 3, 128, 0, 0, False, False),
    (3, 8, 8, 1, 64, 8, 0, True, False),          # shorter than one tile
    (1, 64, 128, 2, 64, 64, 0, False, True),      # Lq < Lk
    (2, 256, 128, 2, 64, 128, 64, True, True),    # Lq > Lk, partly masked
    (1, 128, 64, 2, 64, 0, 64, True, True),       # hidden by the mask
])
def test_flash_attention_carry_matches_plain(device, b, l_q, l_k, h, d,
                                             q_offset, k_offset, causal,
                                             carried, dtype):
  gen = _generator(device, 7)
  qkv = torch.randn((b, l_q, h, 3, d), device=device, generator=gen).to(
      dtype)
  kv = torch.randn((b, l_k, h, 2, d), device=device, generator=gen).to(dtype)
  q, k, v = qkv[..., 0, :], kv[..., 0, :], kv[..., 1, :]
  scale = 1.0 / d ** 0.5
  state = (torch.zeros((b, h, l_q, d), device=device),
           torch.full((b, h, l_q), flash_attention.NEG_INF, device=device),
           torch.zeros((b, h, l_q), device=device))
  if carried:   # the state after an earlier full hop
    flash_attention.flash_attention_carry_plain(
        q, qkv[..., 1, :], qkv[..., 2, :], *state, q_offset, q_offset - l_q,
        causal, scale)
  got = tuple(x.clone() for x in state)
  want = tuple(x.clone() for x in state)
  before = kernels.LAUNCHES['flash_attention_carry']
  out = flash_attention.flash_attention_carry(q, k, v, *got, q_offset,
                                              k_offset, causal, scale)
  assert kernels.LAUNCHES['flash_attention_carry'] == before + 1
  assert all(o is g for o, g in zip(out, got))
  flash_attention.flash_attention_carry_plain(q, k, v, *want, q_offset,
                                              k_offset, causal, scale)
  torch.cuda.synchronize()
  for name, g, w in zip('oml', got, want):
    err = float((g - w).abs().max())
    assert err <= CARRY_RTOL * float(w.abs().max()), (name, err)
  if causal and k_offset > q_offset + l_q - 1:
    assert all(torch.equal(g, s) for g, s in zip(got, state))


def test_flash_attention_carry_refuses_what_it_does_not_take(device):
  q = torch.randn(1, 64, 2, 64, device=device)
  state = (torch.zeros(1, 2, 64, 64, device=device),
           torch.zeros(1, 2, 64, device=device),
           torch.zeros(1, 2, 64, device=device))
  with pytest.raises(ValueError, match='float32'):
    flash_attention.flash_attention_carry(
        q, q, q, state[0].double(), *state[1:], 0, 0, True, 0.125)
  with pytest.raises(ValueError, match='contiguous'):
    flash_attention.flash_attention_carry(
        q, q, q, state[0].transpose(2, 3), *state[1:], 0, 0, True, 0.125)
  with pytest.raises(ValueError, match='head dims'):
    x = torch.randn(1, 64, 2, 32, device=device)
    flash_attention.flash_attention_carry(
        x, x, x, torch.zeros(1, 2, 64, 32, device=device), *state[1:], 0, 0,
        True, 0.125)
