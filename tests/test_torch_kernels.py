"""The port's kernels K1 (crop + convert) and K2 (max pool forward) against
the JAX package, on the CPU.

On a CPU tensor each wrapper runs its plain PyTorch version, which is what
the card's kernel is held against in ``chip_smoke.py`` and
``tests/test_torch_cuda.py``. Here the plain versions are held against the
JAX package's Pallas kernels in interpret mode and against its default
XLA path as the package runs it (jitted). Tolerance: none. The crop's
``image / 255.0`` compiles, in XLA and in the Pallas kernel, to a multiply
by the float32 reciprocal, which the port computes too, and a pool selects
input values, so the results must agree bit for bit, and the int8 window
index exactly.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.layers import pallas_pooling
from tensor2robot_tpu.layers import pooling as jax_pooling
from tensor2robot_tpu.preprocessors import image_transformations as jax_it
from tensor2robot_tpu.preprocessors import pallas_crop as jax_crop
from tensor2robot_tpu_torch import kernels
from tensor2robot_tpu_torch.layers import pooling
from tensor2robot_tpu_torch.preprocessors import image_transformations
from tensor2robot_tpu_torch.preprocessors import pallas_crop

# The geometries of tests/test_layers.py TestPallasMaxPool.
PALLAS_CASES = [
    ((2, 35, 35, 8), (3, 3), 'SAME'),     # high-pad row + 2-col tail
    ((1, 27, 27, 8), (2, 2), 'SAME'),     # 1-col tail
    ((2, 24, 24, 8), (2, 2), 'VALID'),
    ((1, 29, 31, 8), (3, 3), 'VALID'),    # non-divisible: tail cropped
    ((1, 30, 30, 8), (3, 3), 'SAME'),     # exact division
]

# Geometries with low padding, outside the Pallas kernel's gate: the served
# 79 -> 27 pool at small size, and a 2/2 pool with one padded column.
LOW_PAD_CASES = [
    ((2, 25, 25, 8), (3, 3), 'SAME'),
    ((2, 79, 79, 4), (3, 3), 'SAME'),
    ((3, 13, 9, 5), (2, 2), 'SAME'),
    ((1, 23, 26, 8), (3, 3), 'VALID'),
]


def _as_f32(x):
  if isinstance(x, torch.Tensor):
    return x.to(torch.float32).numpy()
  return np.asarray(x).astype(np.float32)


def _crop_inputs(seed, shape, target):
  rng = np.random.RandomState(seed)
  b, h, w, _ = shape
  images = rng.randint(0, 256, shape, dtype=np.uint8)
  offsets = np.stack([rng.randint(0, h - target[0] + 1, b),
                      rng.randint(0, w - target[1] + 1, b)],
                     -1).astype(np.int32)
  # Zero, max-valid and out-of-range offsets clamp like dynamic_slice.
  offsets[0] = (0, 0)
  offsets[1] = (h - target[0], w - target[1])
  offsets[2] = (100, 1000)
  offsets[3] = (-7, -1)
  return images, offsets


@pytest.mark.parametrize('out_dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape,target', [
    ((5, 16, 128, 3), (8, 64)),
    ((4, 64, 128, 1), (40, 56)),
])
def test_crop_convert_plain_matches_pallas_interpret(shape, target,
                                                     out_dtype):
  images, offsets = _crop_inputs(0, shape, target)
  want = jax_crop.fused_crop_convert(jnp.asarray(images), offsets, target,
                                     out_dtype=jnp.dtype(out_dtype),
                                     interpret=True)
  got = pallas_crop.crop_convert(torch.from_numpy(images),
                                 torch.from_numpy(offsets), target,
                                 getattr(torch, out_dtype))
  assert got.dtype == getattr(torch, out_dtype)
  np.testing.assert_array_equal(_as_f32(got), _as_f32(want))


def test_crop_convert_plain_matches_center_crop_and_divide():
  rng = np.random.RandomState(1)
  images = rng.randint(0, 256, (3, 512, 640, 3), dtype=np.uint8)
  # The PREDICT preprocessor's crop + divide, compiled as the serving
  # program compiles it.
  want = jax.jit(lambda im: jnp.asarray(jax_it.center_crop_images(
      [im], (472, 472))[0], jnp.float32) / 255.0)(jnp.asarray(images))
  offsets = image_transformations.center_crop_offsets(3, (512, 640),
                                                      (472, 472))
  assert offsets.tolist() == [[20, 84]] * 3
  got = pallas_crop.crop_convert_plain(torch.from_numpy(images), offsets,
                                       (472, 472))
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_crop_images_clamps_like_dynamic_slice():
  images, offsets = _crop_inputs(2, (4, 16, 24, 2), (8, 10))
  # lax.dynamic_slice wraps a negative index Python-style before it
  # clamps; the Pallas wrapper (and the port) clamp it to 0. Only
  # non-negative offsets are compared here; negatives are in the Pallas
  # comparison above.
  offsets[3] = (9, 15)
  want = jax_it.crop_images([jnp.asarray(images)], jnp.asarray(offsets),
                            (8, 10))[0]
  got = image_transformations.crop_images(
      [torch.from_numpy(images)], torch.from_numpy(offsets), (8, 10))[0]
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape,window,padding', PALLAS_CASES)
def test_max_pool_plain_matches_pallas_interpret(shape, window, padding,
                                                 dtype):
  rng = np.random.RandomState(0)
  x = rng.randn(*shape).astype(np.float32)
  xj = jnp.asarray(x, dtype)
  want = pallas_pooling.max_pool_pallas(xj, window, padding, True)
  _, want_idx = pallas_pooling._pallas_call_fwd(xj, window, padding, True)
  xt = torch.from_numpy(x).to(getattr(torch, dtype))
  got, idx = pooling.max_pool(xt, window, window, padding,
                              return_index=True)
  assert got.dtype == xt.dtype and idx.dtype == torch.int8
  np.testing.assert_array_equal(_as_f32(got), _as_f32(want))
  np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))


def test_max_pool_index_follows_the_stagewise_tie_rule():
  # bf16 rounds many values together, so windows hold exact ties; the
  # index must still match the Pallas kernel's first-max-per-stage rule.
  rng = np.random.RandomState(3)
  x = np.round(rng.randn(2, 30, 30, 8) * 2).astype(np.float32)
  _, want_idx = pallas_pooling._pallas_call_fwd(jnp.asarray(x), (3, 3),
                                                'SAME', True)
  _, idx = pooling.max_pool(torch.from_numpy(x), (3, 3), (3, 3), 'SAME',
                            return_index=True)
  np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))


@pytest.mark.parametrize('shape,window,padding',
                         LOW_PAD_CASES + PALLAS_CASES)
def test_max_pool_plain_matches_jax_default_path(shape, window, padding):
  rng = np.random.RandomState(4)
  x = rng.randn(*shape).astype(np.float32)
  xj = jnp.asarray(x)
  want = jax_pooling.max_pool(xj, window, strides=window, padding=padding)
  # The index path's two int8 grids combine into the window index.
  _, (i1, i2, _, _) = jax_pooling._max_pool_fwd(xj, window, padding)
  b, ho, wo, c = i2.shape
  ww = window[1]
  i1 = np.asarray(i1).reshape(b, ho, wo, ww, c)
  i2 = np.asarray(i2).astype(np.int64)
  want_idx = (np.take_along_axis(i1, i2[:, :, :, None, :], 3)[:, :, :, 0]
              * ww + i2)
  got, idx = pooling.max_pool(torch.from_numpy(x), window, window, padding,
                              return_index=True)
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  np.testing.assert_array_equal(idx.numpy(), want_idx)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
  kernels.reset_launches()
  x = torch.randn(2, 9, 9, 4)
  assert torch.equal(pooling.max_pool(x, (3, 3), (3, 3), 'SAME'),
                     pooling.max_pool_plain(x, (3, 3), (3, 3), 'SAME'))
  images = torch.randint(0, 256, (2, 16, 20, 3), dtype=torch.uint8)
  offsets = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
  assert torch.equal(pallas_crop.crop_convert(images, offsets, (8, 8)),
                     pallas_crop.crop_convert_plain(images, offsets, (8, 8)))
  assert kernels.LAUNCHES == dict.fromkeys(kernels.KERNELS, 0)


VECTOR_WIDTH_CASES = [
    (torch.float32, 64, 0, 4),     # the critic's pools: 16-byte vectors
    (torch.float32, 4, 0, 4),
    (torch.float32, 12, 0, 4),
    (torch.float32, 5, 0, 1),      # C not a multiple of 4
    (torch.float32, 64, 1, 1),     # data 4 bytes past a 16-byte start
    (torch.bfloat16, 16, 0, 8),
    (torch.bfloat16, 8, 0, 8),
    (torch.bfloat16, 12, 0, 1),    # C not a multiple of 8
    (torch.bfloat16, 64, 4, 1),    # data 8 bytes past a 16-byte start
]


def _aligned_view(dtype, shape, offset):
  """A contiguous ``shape`` view whose data starts ``offset`` elements past
  a 16-byte boundary."""
  n = int(np.prod(shape))
  storage = torch.zeros(n + 64, dtype=dtype)
  start = (-storage.data_ptr() // storage.element_size()) % (
      16 // storage.element_size())   # the first 16-byte aligned element
  x = storage[start + offset:start + offset + n].view(shape)
  assert x.is_contiguous()
  return x


@pytest.mark.parametrize('dtype,channels,offset,width', VECTOR_WIDTH_CASES)
def test_max_pool_vector_width(dtype, channels, offset, width):
  """K2f loads 16 bytes of channels at once only where C and the input's
  address allow it; any other pool takes the kernel's one-element
  instance."""
  x = _aligned_view(dtype, (2, 6, 6, channels), offset)
  assert pooling.vector_width(x) == width


@pytest.mark.parametrize('dtype,channels,offset,width', VECTOR_WIDTH_CASES)
def test_max_pool_backward_vector_width(dtype, channels, offset, width):
  """K2b moves dy and its int8 index by the forward's rule: 16 bytes of dy
  (and 4 or 8 of the index) where C and dy's address allow it."""
  dy = _aligned_view(dtype, (2, 6, 6, channels), offset)
  index = _aligned_view(torch.int8, (2, 6, 6, channels), 0)
  assert pooling.vector_width(dy, index) == width


@pytest.mark.parametrize('dtype,index_offset,width', [
    (torch.float32, 4, 4),    # 4 index bytes a thread: 4-byte aligned
    (torch.float32, 2, 1),
    (torch.bfloat16, 8, 8),   # 8 index bytes a thread: 8-byte aligned
    (torch.bfloat16, 4, 1),
    (torch.bfloat16, 1, 1),
])
def test_max_pool_backward_vector_width_needs_an_aligned_index(
    dtype, index_offset, width):
  """K2b loads a thread's indices in one 4- or 8-byte load: an index that
  does not start on a multiple of the width takes the one-element
  instance."""
  dy = _aligned_view(dtype, (2, 6, 6, 64), 0)
  index = _aligned_view(torch.int8, (2, 6, 6, 64), index_offset)
  assert pooling.vector_width(dy, index) == width


def test_other_devices_raise_instead_of_falling_back():
  x = torch.empty(2, 9, 9, 4, device='meta')
  with pytest.raises(ValueError, match='CUDA or CPU'):
    pooling.max_pool(x, (3, 3), (3, 3), 'SAME')
  images = torch.empty(2, 16, 20, 3, dtype=torch.uint8, device='meta')
  with pytest.raises(ValueError, match='CUDA or CPU'):
    pallas_crop.crop_convert(images, torch.zeros(2, 2, dtype=torch.int32),
                             (8, 8))


def test_wrappers_reject_what_the_kernels_do_not_take():
  x = torch.randn(2, 9, 9, 4)
  with pytest.raises(ValueError, match='non-overlapping'):
    pooling.max_pool(x, (3, 3), (2, 2), 'SAME')
  with pytest.raises(ValueError, match='SAME or VALID'):
    pooling.max_pool(x, (3, 3), (3, 3), 'FULL')
  with pytest.raises(ValueError, match='NHWC'):
    pooling.max_pool(x[0], (3, 3), (3, 3), 'SAME')
  images = torch.zeros(2, 16, 20, 3, dtype=torch.uint8)
  with pytest.raises(ValueError, match='uint8'):
    pallas_crop.crop_convert(images.float(), torch.zeros(2, 2), (8, 8))
  with pytest.raises(ValueError, match='does not fit'):
    pallas_crop.crop_convert(images, torch.zeros(2, 2), (17, 8))
  with pytest.raises(ValueError, match=r'\[B, 2\]'):
    pallas_crop.crop_convert(images, torch.zeros(3, 2), (8, 8))


def test_an_included_header_rebuilds_the_kernel(tmp_path, monkeypatch):
  """A built library's name hashes the source and every csrc header it
  includes (recursively), so an edit to a shared header rebuilds every
  kernel that includes it. No nvcc needed: only the names are computed."""
  (tmp_path / 'k.cu').write_text('#include "a.cuh"\n#include <stdint.h>\n'
                                 'int f() { return 1; }\n')
  (tmp_path / 'a.cuh').write_text('#pragma once\n#include "b.cuh"\n')
  (tmp_path / 'b.cuh').write_text('#pragma once\n')
  (tmp_path / 'other.cu').write_text('int g() { return 2; }\n')
  monkeypatch.setattr(kernels, 'CSRC_DIR', tmp_path)
  assert [p.name for p in kernels._sources(kernels.source_path('k'))] == [
      'k.cu', 'a.cuh', 'b.cuh']
  before = kernels.library_path('k')
  other = kernels.library_path('other')
  assert before == kernels.library_path('k')   # stable
  (tmp_path / 'b.cuh').write_text('#pragma once\n// edited\n')
  after = kernels.library_path('k')
  assert after != before and after.name.startswith('k-')
  assert kernels.library_path('other') == other   # includes no header
  (tmp_path / 'a.cuh').write_text('#pragma once\n')   # drops b.cuh
  assert kernels.library_path('k') not in (before, after)
  # The port's own kernels: K3, K4, K5a and K5b share the 3xTF32 header.
  monkeypatch.undo()
  for name in ('conv5x5_wgrad', 'flash_attention_fwd',
               'flash_attention_bwd_kv', 'flash_attention_bwd_q'):
    assert 'tf32_mma.cuh' in [p.name for p in kernels._sources(
        kernels.source_path(name))]
  # K4, K5a and K5b read their tiles through one swizzle.
  for name in ('flash_attention_fwd', 'flash_attention_bwd_kv',
               'flash_attention_bwd_q'):
    assert 'flash_tile.cuh' in [p.name for p in kernels._sources(
        kernels.source_path(name))]
  # K4 and K6 run one forward tile loop, and K6 the 3xTF32 products.
  for name in ('flash_attention_fwd', 'flash_attention_carry'):
    assert {'flash_fwd.cuh', 'flash_tile.cuh', 'tf32_mma.cuh'} <= {
        p.name for p in kernels._sources(kernels.source_path(name))}
  # K5a's and K5b's bf16 instances live in one header, K4's and K6's in
  # another, all four on the bf16 mma.sync helpers: an edit to a kernel
  # header rebuilds its two libraries, one to the helpers all four, and no
  # other.
  bf16 = ('flash_attention_bwd_kv', 'flash_attention_bwd_q')
  fwd_bf16 = ('flash_attention_fwd', 'flash_attention_carry')
  for name in bf16:
    assert {'flash_bwd_bf16.cuh', 'bf16_mma.cuh'} <= {
        p.name for p in kernels._sources(kernels.source_path(name))}
  for name in fwd_bf16:
    assert {'flash_fwd_bf16.cuh', 'bf16_mma.cuh'} <= {
        p.name for p in kernels._sources(kernels.source_path(name))}
  copy = tmp_path / 'csrc'
  shutil.copytree(kernels.CSRC_DIR, copy)
  monkeypatch.setattr(kernels, 'CSRC_DIR', copy)
  names = tuple(kernels.KERNELS)
  before = {name: kernels.library_path(name) for name in names}
  for header, rebuilt in (('flash_bwd_bf16.cuh', bf16),
                          ('flash_fwd_bf16.cuh', fwd_bf16),
                          ('bf16_mma.cuh', bf16 + fwd_bf16)):
    with open(copy / header, 'a') as f:
      f.write('// edited\n')
    after = {name: kernels.library_path(name) for name in names}
    assert {name for name in names if after[name] != before[name]} == set(
        rebuilt), header
    before = after
