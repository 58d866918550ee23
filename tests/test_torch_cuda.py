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
was, bit for bit), a hop hidden from its first warp's queries only (whose
rows must stay bit for bit as they were), head dim 128 in bf16 at the
4-rank hop's offsets, and a carried state as well as the initial one; the
same bits run to run, and a view whose rows are not 16-byte aligned is
refused. K4's and K6's bf16 instances (their own kernel, p rounded to bf16
in K4 and split into two bf16 halves in K6) are held to the same bounds
at lengths one short of, at and one past their 128-query blocks, 32-query
warps and 64-key tiles, and K6's bf16 rows that see no key, also beside
rows of their warp that do, stay bit for bit as they were.
The record path on the card: the native loader's batch (decoded by nvJPEG
where the host has no libjpeg) copied to the card equals the batch on the
host bit for bit, and its pixels are within 4 of libjpeg's (OpenCV's) on
the same records: only nvJPEG's IDCT differs, by up to 1 in Y, Cb and Cr,
which the colour conversion takes to up to 3 in R, G or B; the same for
one Seq2Act batch of episodes. The loader decodes on the card it is given:
on card 1 where given card 1 (with two cards), and a card the host lacks
fails the first batch, with no card bound in its place. And serve.py's
hot swap at a small critic: a newer checkpoint is served while requests go
on, with no request failed. The split decode on the card: the sparse and
packed coefficient wires unpacked by the feed equal the dense planes bit
for bit, the finish on the card is within 1 level of the CPU's and within
4 of OpenCV's decode, the coefficient loader binds no card, and the
pipelined feed hands batches over in order. The photometric distortions
(plain PyTorch, no kernel of their own) on the card equal the CPU's on
the same draws within 1e-5 (the contrast's mean sums in another order),
the depth distortions bit for bit.
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


def test_flash_attention_backward_bf16_refuses_unaligned_rows(device):
  """K5a's and K5b's bf16 instances copy rows 16 bytes (8 elements) at a
  time: a bf16 view whose rows start 8 bytes past 16 raises instead of
  reading them."""
  base = torch.randn(4 + 64 * 2 * 64, device=device).to(torch.bfloat16)
  q = base[4:].view(1, 64, 2, 64)        # 8 bytes past an aligned start
  k = torch.randn(1, 64, 2, 64, device=device).to(torch.bfloat16)
  lse = torch.zeros(1, 2, 64, device=device)
  for backward in (flash_attention.flash_attention_bwd_kv,
                   flash_attention.flash_attention_bwd_q):
    with pytest.raises(ValueError, match='16-byte aligned'):
      backward(q, k, k, k, lse, lse, True, 0.125)


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
    (2, 128, 128, 2, 64, 128, 148, True, True),   # the first warp hidden
    (1, 256, 256, 2, 128, 256, 256, True, True),  # 4-rank diagonal hop
    (1, 256, 256, 2, 128, 512, 0, True, True),    # 4-rank full hop
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
  # Rows whose queries all precede the first key: a warp of 16 that takes
  # no key tile leaves them as they were.
  hidden = 16 * max(0, min(k_offset - q_offset, l_q) // 16) if causal else 0
  assert all(torch.equal(g[:, :, :hidden], s[:, :, :hidden])
             for g, s in zip(got, state))


def test_flash_attention_carry_same_bits_run_to_run(device):
  gen = _generator(device, 8)
  qkv = torch.randn((2, 256, 2, 3, 64), device=device, generator=gen)
  runs = []
  for _ in range(2):
    state = (torch.zeros((2, 2, 256, 64), device=device),
             torch.full((2, 2, 256), flash_attention.NEG_INF, device=device),
             torch.zeros((2, 2, 256), device=device))
    flash_attention.flash_attention_carry(
        qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :], *state, 256, 200,
        True, 0.125)
    runs.append(state)
  torch.cuda.synchronize()
  assert all(torch.equal(a, b) for a, b in zip(*runs))


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
  with pytest.raises(ValueError, match='16-byte aligned'):
    x = torch.randn(1, 64, 2, 65, device=device)[..., 1:]
    flash_attention.flash_attention_carry(x, q, q, *state, 0, 0, True, 0.125)


# The bf16 instances of K4 and K6 (csrc/flash_fwd_bf16.cuh) tile 128 queries
# a block (K4 at D = 64: warps of 32 queries; K6 and D = 128: warps of 16)
# and 64 keys (K6 at D = 128: 32): lengths one short of, at and one past
# those edges, Lq != Lk, and both head dims.
@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('b,l_q,l_k,h,d', [
    (2, 127, 127, 2, 64),
    (1, 129, 129, 3, 64),
    (2, 33, 65, 2, 64),
    (1, 257, 63, 2, 128),
    (2, 96, 160, 1, 128),
])
def test_flash_attention_bf16_matches_plain_at_tile_edges(device, b, l_q, l_k,
                                                          h, d, causal):
  gen = _generator(device, 9)
  q = torch.randn((b, l_q, h, d), device=device, generator=gen).to(
      torch.bfloat16)
  kv = torch.randn((b, l_k, h, 2, d), device=device, generator=gen).to(
      torch.bfloat16)
  k, v = kv[..., 0, :], kv[..., 1, :]
  before = kernels.LAUNCHES['flash_attention_fwd']
  out, lse = flash_attention.flash_attention_forward(q, k, v, causal,
                                                     d ** -0.5)
  assert kernels.LAUNCHES['flash_attention_fwd'] == before + 1
  want_o, want_lse = flash_attention.flash_attention_plain_blhd(
      q, k, v, causal, d ** -0.5)
  torch.cuda.synchronize()
  assert out.dtype == torch.bfloat16 and out.shape == (b, l_q, h, d)
  assert float((out.float() - want_o.float()).abs().max()) <= (
      FLASH_ATOL[torch.bfloat16])
  assert float((lse - want_lse).abs().max()) <= 1e-5


@pytest.mark.parametrize('scale', [-0.125, 0.0])
def test_flash_attention_bf16_takes_a_scale_that_is_not_positive(device,
                                                                 scale):
  """The bf16 kernels take a tile's max from the unscaled scores only for a
  positive scale; any other scale takes the guarded path."""
  gen = _generator(device, 12)
  qkv = torch.randn((2, 256, 2, 3, 64), device=device, generator=gen).to(
      torch.bfloat16)
  q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
  out, lse = flash_attention.flash_attention_forward(q, k, v, True, scale)
  want_o, want_lse = flash_attention.flash_attention_plain_blhd(
      q, k, v, True, scale)
  state = (torch.zeros((2, 2, 256, 64), device=device),
           torch.full((2, 2, 256), flash_attention.NEG_INF, device=device),
           torch.zeros((2, 2, 256), device=device))
  got = tuple(x.clone() for x in state)
  flash_attention.flash_attention_carry(q, k, v, *got, 0, 0, True, scale)
  flash_attention.flash_attention_carry_plain(q, k, v, *state, 0, 0, True,
                                              scale)
  torch.cuda.synchronize()
  assert float((out.float() - want_o.float()).abs().max()) <= (
      FLASH_ATOL[torch.bfloat16])
  assert float((lse - want_lse).abs().max()) <= 1e-5
  for name, g, w in zip('oml', got, state):
    err = float((g - w).abs().max())
    assert err <= CARRY_RTOL * float(w.abs().max()), (name, err)


@pytest.mark.parametrize('b,l_q,l_k,h,d,q_offset,k_offset', [
    (2, 128, 128, 2, 64, 128, 148),   # rows 0-19 see no key
    (1, 256, 72, 3, 128, 40, 100),    # rows 0-59 see no key
])
def test_flash_attention_carry_bf16_leaves_rows_that_see_no_key(
    device, b, l_q, l_k, h, d, q_offset, k_offset):
  """K6's bf16 instance writes no row whose query precedes every key, also
  where the row shares its warp with rows that do see keys."""
  gen = _generator(device, 10)
  qkv = torch.randn((b, l_q, h, 3, d), device=device, generator=gen).to(
      torch.bfloat16)
  kv = torch.randn((b, l_k, h, 2, d), device=device, generator=gen).to(
      torch.bfloat16)
  q, k, v = qkv[..., 0, :], kv[..., 0, :], kv[..., 1, :]
  scale = d ** -0.5
  state = (torch.zeros((b, h, l_q, d), device=device),
           torch.full((b, h, l_q), flash_attention.NEG_INF, device=device),
           torch.zeros((b, h, l_q), device=device))
  flash_attention.flash_attention_carry_plain(
      q, qkv[..., 1, :], qkv[..., 2, :], *state, q_offset, q_offset - l_q,
      True, scale)
  got = tuple(x.clone() for x in state)
  want = tuple(x.clone() for x in state)
  flash_attention.flash_attention_carry(q, k, v, *got, q_offset, k_offset,
                                        True, scale)
  flash_attention.flash_attention_carry_plain(q, k, v, *want, q_offset,
                                              k_offset, True, scale)
  torch.cuda.synchronize()
  for name, g, w in zip('oml', got, want):
    err = float((g - w).abs().max())
    assert err <= CARRY_RTOL * float(w.abs().max()), (name, err)
  hidden = k_offset - q_offset
  assert all(torch.equal(g[:, :, :hidden], x[:, :, :hidden])
             for g, x in zip(got, state))
  assert not torch.equal(got[0][:, :, hidden:], state[0][:, :, hidden:])


def test_flash_attention_carry_bf16_same_bits_run_to_run(device):
  gen = _generator(device, 11)
  qkv = torch.randn((2, 256, 2, 3, 64), device=device, generator=gen).to(
      torch.bfloat16)
  runs = []
  for _ in range(2):
    state = (torch.zeros((2, 2, 256, 64), device=device),
             torch.full((2, 2, 256), flash_attention.NEG_INF, device=device),
             torch.zeros((2, 2, 256), device=device))
    flash_attention.flash_attention_carry(
        qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :], *state, 256, 200,
        True, 0.125)
    runs.append(state)
  torch.cuda.synchronize()
  assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_flash_attention_fwd_and_carry_bf16_refuse_unaligned_rows(device):
  """K4's and K6's bf16 instances copy rows 16 bytes (8 elements) at a
  time: a bf16 view whose rows start 8 bytes past 16 raises instead of
  reading them."""
  base = torch.randn(4 + 64 * 2 * 64, device=device).to(torch.bfloat16)
  q = base[4:].view(1, 64, 2, 64)        # 8 bytes past an aligned start
  k = torch.randn(1, 64, 2, 64, device=device).to(torch.bfloat16)
  state = (torch.zeros(1, 2, 64, 64, device=device),
           torch.zeros(1, 2, 64, device=device),
           torch.zeros(1, 2, 64, device=device))
  before = dict(kernels.LAUNCHES)
  for args in ((q, k, k), (k, q, k), (k, k, q)):
    with pytest.raises(ValueError, match='16-byte aligned'):
      flash_attention.flash_attention_forward(*args, True, 0.125)
    with pytest.raises(ValueError, match='16-byte aligned'):
      flash_attention.flash_attention_carry(*args, *state, 0, 0, True,
                                            0.125)
  assert kernels.LAUNCHES == before


def _write_frames(path, rng, count, shape=(48, 64, 3)):
  """``count`` records of a JPEG frame (OpenCV), a float vector and an int
  id, by the port's writer; returns their specs."""
  import cv2
  import numpy as np

  from tensor2robot_tpu_torch.data.writer import TFRecordReplayWriter
  from tensor2robot_tpu_torch.specs.tensor_spec import TensorSpec

  spec = {'image': TensorSpec(shape, np.uint8, name='image',
                              data_format='jpeg'),
          'vec': TensorSpec((3,), np.float32, name='vec'),
          'uid': TensorSpec((1,), np.int64, name='uid')}
  with TFRecordReplayWriter() as writer:
    writer.open(path)
    for i in range(count):
      yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
      image = np.clip(np.stack([xx * 4, yy * 5, xx + yy], -1) % 256 +
                      rng.randint(-30, 30, shape), 0, 255).astype(np.uint8)
      ok, encoded = cv2.imencode('.jpg', image[..., ::-1])
      assert ok
      writer.write_numpy(spec, {'image': encoded.tobytes(),
                                'vec': rng.rand(3).astype(np.float32),
                                'uid': np.asarray([i], np.int64)})
  return spec


def test_loader_batch_on_the_card_equals_the_host_batch(device, tmp_path):
  import numpy as np

  from tensor2robot_tpu_torch.data import native_loader
  from tensor2robot_tpu_torch.data import parser
  from tensor2robot_tpu_torch.data import tfrecord
  from tensor2robot_tpu_torch.research.qtopt import t2r_models
  from tensor2robot_tpu_torch.trainer.train_eval import Trainer

  path = str(tmp_path / 'frames.tfrecord')
  spec = _write_frames(path, np.random.RandomState(0), 8)
  plan = native_loader.plan_for_specs(spec, {})
  stream = native_loader.NativeBatchedStream(plan, [path], batch_size=4,
                                             num_epochs=1, num_threads=3)
  try:
    batches = [features for features, _ in stream]
  finally:
    stream.close()
  assert len(batches) == 2

  trainer = Trainer(
      t2r_models.Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(
          device=device), str(tmp_path / 'model'))
  want = parser.ExampleParser(spec).parse_batch(
      tfrecord.read_all_records(path))[0]
  tolerance = 4 if native_loader.decoder() == 'nvjpeg' else 0
  for i, batch in enumerate(batches):
    on_card = trainer.put_batch(batch)
    for key, value in batch.items():
      assert on_card[key].device.type == 'cuda'
      assert torch.equal(on_card[key].cpu(), torch.from_numpy(value)), key
    diff = np.abs(batch['image'].astype(int) -
                  want['image'][4 * i:4 * i + 4].astype(int))
    assert diff.max() <= tolerance
    np.testing.assert_array_equal(batch['uid'], want['uid'][4 * i:4 * i + 4])
    np.testing.assert_array_equal(batch['vec'], want['vec'][4 * i:4 * i + 4])


def test_serve_hot_swaps_a_newer_checkpoint_at_a_small_size(device,
                                                            tmp_path):
  import threading

  import numpy as np

  from tensor2robot_tpu_torch.research.qtopt import t2r_models
  from tensor2robot_tpu_torch.serving import serve
  from tensor2robot_tpu_torch.trainer import checkpointing

  model = t2r_models.Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(
      device=device, network_kwargs={'num_convs': (1, 1, 1)})
  state = model.create_train_state(torch.Generator().manual_seed(0))
  state.step = 1
  manager = checkpointing.CheckpointManager(str(tmp_path))
  manager.save(state)
  kernels.reset_launches()
  serving = serve.start(serve.make_parser().parse_args([
      '--device', 'cuda', '--checkpoint_dir', str(tmp_path), '--num_convs',
      '1,1,1', '--poll_secs', '0.1', '--max_batch_size', '2',
      '--cem_samples', '8', '--cem_iters', '2', '--num_elites', '3']))
  load = {}
  client = threading.Thread(target=lambda: load.update(
      serve.run_synthetic_load(serving.service, serving.feature_spec, 2,
                               3.0)))
  request = serve.synthetic_state(serving.feature_spec,
                                  np.random.RandomState(0))
  try:
    assert serving.service.select_action(request, timeout_s=60).version == 1
    client.start()
    state.step = 2
    state.avg_params = {k: v * 1.5 for k, v in state.avg_params.items()}
    manager.save(state)
    client.join(timeout=120)
    assert serving.service.select_action(request, timeout_s=60).version == 2
  finally:
    serving.stop()
  assert load['failed'] == 0
  assert '2' in load['versions_served']
  assert set(load['versions_served']) <= {'1', '2'}
  assert [version for version, _ in serving.swaps] == [2]
  # A batch crops once and pools 5 times: the stem, pool2, and pool3 at
  # each of the 2 CEM iterations and at the chosen actions' q.
  assert kernels.LAUNCHES['crop_convert'] > 0
  assert kernels.LAUNCHES['max_pool'] == 5 * kernels.LAUNCHES['crop_convert']


def _nvjpeg_stream(tmp_path, device_index, count=4):
  """A stream of frames written as in the loader test, decoding on
  ``device_index``; skips where the loader decodes with libjpeg (which
  uses no card)."""
  import numpy as np

  from tensor2robot_tpu_torch.data import native_loader

  if native_loader.decoder() != 'nvjpeg':
    pytest.skip('the loader decodes with libjpeg on this host: no card')
  path = str(tmp_path / 'frames.tfrecord')
  spec = _write_frames(path, np.random.RandomState(0), count)
  return native_loader.NativeBatchedStream(
      native_loader.plan_for_specs(spec, {}), [path], batch_size=2,
      num_epochs=1, num_threads=2, device=device_index)


def test_loader_refuses_a_card_the_host_lacks(device, tmp_path):
  missing = torch.cuda.device_count()
  stream = _nvjpeg_stream(tmp_path, missing)
  try:
    with pytest.raises(RuntimeError, match='CUDA device {} is not on this '
                       'host, which has {} '.format(missing, missing)):
      next(iter(stream))
    # No worker bound a card: none decoded on card 0 in its place.
    assert stream.stats()['decode_device'] == -1
  finally:
    stream.close()


def test_loader_decodes_on_the_card_it_is_given(device, tmp_path):
  """Given card 1, the stream's nvJPEG state lies on card 1: its free
  memory falls, and by more than card 0's. The planes path given card 1
  decodes there and leaves the caller's current device as it was."""
  import cv2
  import numpy as np

  from tensor2robot_tpu_torch.data import native_loader

  if torch.cuda.device_count() < 2:
    pytest.skip('needs two CUDA cards')
  free_before = [torch.cuda.mem_get_info(i)[0] for i in (0, 1)]
  stream = _nvjpeg_stream(tmp_path, 1)
  try:
    batches = [features for features, _ in stream]
    assert len(batches) == 2
    assert stream.stats()['decode_device'] == 1
    free_after = [torch.cuda.mem_get_info(i)[0] for i in (0, 1)]
  finally:
    stream.close()
  fell = [before - after for before, after in zip(free_before, free_after)]
  assert fell[1] > 0 and fell[1] > fell[0], fell
  current = torch.cuda.current_device()
  image = batches[0]['image'][0]
  ok, encoded = cv2.imencode('.jpg', image)
  assert ok
  on_card_1 = native_loader.decode_jpeg_planes(encoded.tobytes(),
                                               image.shape, device=1)
  assert torch.cuda.current_device() == current
  np.testing.assert_array_equal(
      on_card_1, native_loader.decode_jpeg_planes(encoded.tobytes(),
                                                  image.shape))


def test_seq2act_batch_from_records_on_the_card(device, tmp_path):
  """One Seq2Act batch of episodes from records (the native loader, nvJPEG
  where the host has no libjpeg) copied to the card: equal to the host
  batch bit for bit, and its frames within 4 levels of the Python
  parser's (OpenCV's), every other field equal."""
  import cv2
  import numpy as np

  from tensor2robot_tpu_torch.data import input_generators
  from tensor2robot_tpu_torch.data import native_loader
  from tensor2robot_tpu_torch.data import parser
  from tensor2robot_tpu_torch.data import tfrecord
  from tensor2robot_tpu_torch.data.writer import TFRecordReplayWriter
  from tensor2robot_tpu_torch.modes import ModeKeys
  from tensor2robot_tpu_torch.research.seq2act import Seq2ActBCModel
  from tensor2robot_tpu_torch.trainer.train_eval import Trainer

  model = Seq2ActBCModel(device=device, episode_length=4)
  feature_spec = model.preprocessor.get_in_feature_specification(
      ModeKeys.TRAIN)
  label_spec = model.preprocessor.get_in_label_specification(ModeKeys.TRAIN)
  spec = {**feature_spec, **label_spec}
  rng = np.random.RandomState(0)
  path = str(tmp_path / 'episodes.tfrecord')
  yy, xx = np.mgrid[0:136, 0:168]
  with TFRecordReplayWriter() as writer:
    writer.open(path)
    for e in range(2):
      frames = []
      for t in range(4):
        image = np.clip(np.stack([xx * 2 + 9 * e, yy * 3 + 5 * t, xx + yy],
                                 -1) % 256 + rng.randint(-9, 10, (136, 168,
                                                                  3)),
                        0, 255).astype(np.uint8)
        ok, encoded = cv2.imencode('.jpg', image[..., ::-1],
                                   [cv2.IMWRITE_JPEG_QUALITY, 95])
        assert ok
        frames.append(encoded.tobytes())
      writer.write_numpy(spec, {'image': frames, 'action': rng.uniform(
          -1, 1, (4, 7)).astype(np.float32)})
  data = input_generators.DefaultRecordInputGenerator(
      file_patterns=path, batch_size=2, use_native=True, prefetch=0)
  trainer = Trainer(model, str(tmp_path / 'model'))
  data.set_specification_from_model(model, ModeKeys.TRAIN)
  iterator = trainer.dataset_iterator(data, ModeKeys.EVAL)
  features, labels = next(iterator)
  iterator.close()
  assert data.stream.stats()['decode_device'] == (
      torch.cuda.current_device() if native_loader.decoder() == 'nvjpeg'
      else -1)
  want, want_labels = parser.ExampleParser(feature_spec, label_spec) \
      .parse_batch(tfrecord.read_all_records(path))
  for arrays in (features, labels):
    on_card = trainer.put_batch(arrays)
    for key, value in arrays.items():
      assert on_card[key].device.type == 'cuda'
      assert torch.equal(on_card[key].cpu(), torch.from_numpy(value)), key
  diff = np.abs(features['image'].astype(int) - want['image'].astype(int))
  assert diff.max() <= 4
  np.testing.assert_array_equal(labels['action'], want_labels['action'])


def _coefficient_batches(path):
  """One batch of each coefficient mode of ``_write_frames``' records."""
  import numpy as np

  from tensor2robot_tpu_torch.data import native_loader

  spec = _write_frames(path, np.random.RandomState(1), 4)
  batches = {}
  for mode in native_loader.COEF_MODES:
    stream = native_loader.NativeBatchedStream(
        native_loader.plan_for_specs(spec, {}, image_mode=mode), [path],
        batch_size=4, num_epochs=1)
    try:
      batches[mode] = next(iter(stream))[0]
      # The entropy stage runs on the host: no card is bound.
      assert stream.stats()['decode_device'] == -1
    finally:
      stream.close()
  return batches


def test_split_decode_on_the_card(device, tmp_path):
  """The coefficient wires through the feed on the card: the sparse and
  packed unpacks equal the dense planes bit for bit, the card's finish is
  within 1 level of the CPU's and within 4 of OpenCV's decode."""
  import cv2
  import numpy as np

  from tensor2robot_tpu_torch.data import device_feed
  from tensor2robot_tpu_torch.data import jpeg_device
  from tensor2robot_tpu_torch.data import tfrecord
  from tensor2robot_tpu_torch.data import wire

  path = str(tmp_path / 'frames.tfrecord')
  batches = _coefficient_batches(path)
  dense = batches['coef']
  feed = device_feed.SparseCoefFeed({'image': (48, 64)}, device)
  for mode in ('coef_sparse', 'coef_packed'):
    features, _ = feed.put_batch((batches[mode], None))
    for part in ('y', 'cb', 'cr', 'qt'):
      got = features['image/' + part]
      assert got.device.type == 'cuda'
      assert torch.equal(got.cpu(), torch.from_numpy(dense['image/' + part]))
  planes = [torch.from_numpy(dense['image/' + k])
            for k in ('y', 'cb', 'cr', 'qt')]
  on_card = jpeg_device.decode_jpeg_coefficients(
      *(p.to(device) for p in planes)).cpu()
  on_cpu = jpeg_device.decode_jpeg_coefficients(*planes)
  assert (on_card.int() - on_cpu.int()).abs().max() <= 1
  host = np.stack([cv2.imdecode(np.frombuffer(
      wire.parse_example(r)['image'][1][0], np.uint8), cv2.IMREAD_COLOR)[
          ..., ::-1] for r in tfrecord.read_all_records(path)])
  assert np.abs(on_card.numpy().astype(int) - host.astype(int)).max() <= 4


@pytest.mark.parametrize('depth', [1, 3])
def test_pipelined_feed_on_the_card_is_fifo(device, tmp_path, depth):
  import numpy as np

  from tensor2robot_tpu_torch.data import device_feed

  batch = _coefficient_batches(str(tmp_path / 'frames.tfrecord'))[
      'coef_sparse']
  feed = device_feed.SparseCoefFeed({'image': (48, 64)}, device)
  batches = [({**batch, 'tag': np.full((4,), i, np.int32)},
              {'label': np.full((4, 1), i, np.float32)}) for i in range(6)]
  pipelined = device_feed.PipelinedFeed(iter(batches), feed, depth=depth)
  got = [(int(f['tag'][0]), float(l['label'][0, 0]), f['image/y'].device.type)
         for f, l in pipelined]
  assert pipelined.close()
  assert got == [(i, float(i), 'cuda') for i in range(6)]


@pytest.mark.parametrize('shape', [(4, 472, 472, 3), (3, 17, 23, 3)])
def test_photometric_distortions_on_the_card_equal_the_cpus(device, shape):
  """Every photometric distortion (plain PyTorch, no kernel of its own) on
  the card against the CPU on the same image and the same draws: all
  elementwise float32 but the contrast's per-image mean, whose sum runs in
  another order, so within 1e-5 on values in [0, 1]; grey pixels and hues
  at the wrap included; the depth distortions bit for bit."""
  from tensor2robot_tpu_torch.preprocessors import image_transformations

  options = {'random_brightness': True, 'random_saturation': True,
             'random_hue': True, 'random_contrast': True,
             'random_noise_level': 0.05, 'random_channel_swap': True}
  gen = _generator(device, 3)
  image = torch.rand(shape, generator=gen, device=device)
  image[0, :4] = 0.5                               # grey
  image[0, 4:6] = torch.tensor([1.0, 0.0, 1e-6], device=device)   # wrap
  parameters = image_transformations.draw_photometric_parameters(
      gen, [image], **options)
  assert all(v.device.type == 'cuda' for v in parameters[0].values())
  card = image_transformations.apply_photometric_image_distortions(
      [image], parameters, **options)[0]
  cpu = image_transformations.apply_photometric_image_distortions(
      [image.cpu()], [{k: v.cpu() for k, v in parameters[0].items()}],
      **options)[0]
  assert card.device.type == 'cuda'
  assert float((card.cpu() - cpu).abs().max()) <= 1e-5
  depth = image[..., :1]
  drawn = image_transformations.draw_depth_parameters(gen, [depth],
                                                      scale_noise=True)
  card = image_transformations.apply_depth_image_distortions(
      [depth], drawn, scale_noise=True)[0]
  cpu = image_transformations.apply_depth_image_distortions(
      [depth.cpu()], [{k: v.cpu() for k, v in drawn[0].items()}],
      scale_noise=True)[0]
  assert torch.equal(card.cpu(), cpu)
