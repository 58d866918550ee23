"""The device half of the split decode: DCT coefficients -> RGB pixels.

The counterpart of the JAX package's ``data/jpeg_device.py``. The native
loader's coefficient modes (``native_loader.plan_for_specs(image_mode=
'coef' | 'coef_sparse' | 'coef_packed')``) stop after the entropy
(Huffman) stage, on the host; this module finishes the decode on the
tensors' device, inside the train step:

    dequantize -> 8x8 IDCT -> blocks to planes -> chroma upsample ->
    YCbCr -> RGB -> round, clip

and first unpacks the sparse and packed wires into the dense coefficient
planes (``unpack_*``: a cumsum and an integer scatter-add, the same bits on
every run and every device).

The IDCT is float32 in every case: its two 8-point passes are written out
as products and sums of whole tensors, in a fixed order, so no matrix
product runs (none can fall to TF32, whatever the caller's flags) and the
card's finish is the CPU's bit for bit. Its output is range-limited to
[0, 255] a plane, as libjpeg limits its samples: the JAX finish omits the
limit, and a luma sample of 258.9 puts its blue 5 levels off libjpeg's
on one of ``chip_smoke.py``'s critic frames (past the 4 that it claims);
the port then differs from JAX's only where a sample leaves that range.
Baseline 4:2:0 frames with dims divisible by 16; the triangle chroma
upsample is libjpeg's default filter in float arithmetic, and with the
float colour conversion (libjpeg's is fixed-point) the pixels are within
4 levels of a host decode.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch

__all__ = ['decode_coef_features', 'decode_jpeg_coefficients',
           'unpack_packed_coefficients', 'unpack_packed_features',
           'unpack_sparse_coefficients', 'unpack_sparse_features']


def _idct_matrix() -> np.ndarray:
  """8x8 DCT-III (inverse DCT-II) basis: x = B @ F @ B.T per block."""
  k = np.arange(8)
  n = np.arange(8)
  basis = np.cos((2 * n[:, None] + 1) * k[None, :] * np.pi / 16)
  alpha = np.full(8, np.sqrt(2.0 / 8.0))
  alpha[0] = np.sqrt(1.0 / 8.0)
  return (basis * alpha[None, :]).astype(np.float32)  # [n, k]


_IDCT_B = _idct_matrix()


def _blocks_to_plane(blocks: torch.Tensor) -> torch.Tensor:
  """[B, Hb, Wb, 8, 8] pixel blocks -> [B, Hb*8, Wb*8] plane."""
  b, hb, wb, _, _ = blocks.shape
  return blocks.permute(0, 1, 3, 2, 4).reshape(b, hb * 8, wb * 8)


def _idct_plane(coef: torch.Tensor, quant: torch.Tensor) -> torch.Tensor:
  """Dequantize + 2D IDCT + level shift + range limit for one component.

  coef: [B, Hb, Wb, 64] int16 quantized coefficients (natural order).
  quant: [B, 64] quantization table.
  Returns [B, Hb*8, Wb*8] float32 clipped to [0, 255] (not rounded).
  """
  f = coef.to(torch.float32) * quant.to(torch.float32)[:, None, None, :]
  f = f.reshape(f.shape[:3] + (8, 8))           # [..., k, l]
  basis = torch.as_tensor(_IDCT_B, device=f.device)
  # g[..., k, m] = sum_l F[k, l] B[m, l], then
  # x[..., n, m] = sum_k B[n, k] g[..., k, m]: float32 products and sums.
  g = f[..., :, 0:1] * basis[:, 0]
  for l in range(1, 8):
    g = g + f[..., :, l:l + 1] * basis[:, l]
  x = basis[:, 0:1] * g[..., 0:1, :]
  for k in range(1, 8):
    x = x + basis[:, k:k + 1] * g[..., k:k + 1, :]
  return torch.clamp(_blocks_to_plane(x) + 128.0, 0.0, 255.0)


def _upsample2x_nearest(plane: torch.Tensor) -> torch.Tensor:
  """Nearest-neighbour 2x chroma upsample ([B, h, w] -> [B, 2h, 2w])."""
  return plane.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def _upsample2x_triangle(plane: torch.Tensor) -> torch.Tensor:
  """libjpeg's default h2v2 'fancy' upsample: 3:1 triangle filter.

  Vertical pass then horizontal pass; each output pixel is 3 parts nearest
  input pixel, 1 part next-nearest, edges replicated (jdsample.c
  h2v2_fancy_upsample, in float arithmetic).
  """
  p = plane
  shift_up = torch.cat([p[:, :1], p[:, :-1]], dim=1)
  shift_dn = torch.cat([p[:, 1:], p[:, -1:]], dim=1)
  v_even = (3.0 * p + shift_up) * 0.25
  v_odd = (3.0 * p + shift_dn) * 0.25
  v = torch.stack([v_even, v_odd], dim=2).reshape(p.shape[0], -1,
                                                  p.shape[2])
  shift_l = torch.cat([v[:, :, :1], v[:, :, :-1]], dim=2)
  shift_r = torch.cat([v[:, :, 1:], v[:, :, -1:]], dim=2)
  h_even = (3.0 * v + shift_l) * 0.25
  h_odd = (3.0 * v + shift_r) * 0.25
  return torch.stack([h_even, h_odd], dim=3).reshape(v.shape[0],
                                                     v.shape[1], -1)


def decode_jpeg_coefficients(y: torch.Tensor, cb: torch.Tensor,
                             cr: torch.Tensor, qt: torch.Tensor,
                             dtype: torch.dtype = torch.uint8,
                             fancy_upsample: bool = True) -> torch.Tensor:
  """Finishes a batch of 4:2:0 JPEGs from quantized DCT coefficients.

  Args:
    y:  [B, H/8, W/8, 64] int16 luma coefficient blocks.
    cb: [B, H/16, W/16, 64] int16 chroma-blue blocks.
    cr: [B, H/16, W/16, 64] int16 chroma-red blocks.
    qt: [B, 3, 64] uint16 quant tables (luma, cb, cr; natural order).
    dtype: uint8 as a host decode gives, or float32 (the same rounded
      levels, for a consumer that converts them at once).
    fancy_upsample: libjpeg's triangle chroma upsample; False repeats each
      chroma sample (nearest).

  Returns: [B, H, W, 3] RGB frames on the coefficients' device.
  """
  upsample = _upsample2x_triangle if fancy_upsample else _upsample2x_nearest
  qt = qt.to(torch.int32)
  luma = _idct_plane(y, qt[:, 0])
  cb_c = upsample(_idct_plane(cb, qt[:, 1])) - 128.0
  cr_c = upsample(_idct_plane(cr, qt[:, 2])) - 128.0
  r = luma + 1.402 * cr_c
  g = luma - 0.344136 * cb_c - 0.714136 * cr_c
  b = luma + 1.772 * cb_c
  rgb = torch.stack([r, g, b], dim=-1)
  rgb = torch.clamp(torch.round(rgb), 0.0, 255.0)   # half to even
  return rgb.to(dtype)


def _geometry(height: int, width: int) -> Tuple[int, int, int]:
  """(luma blocks, blocks of one chroma plane, coefficients) of a frame."""
  yb = (height // 8) * (width // 8)
  cbn = (height // 16) * (width // 16)
  return yb, cbn, (yb + 2 * cbn) * 64


def _split_planes(dense: torch.Tensor, height: int, width: int):
  """[B, coefficients] -> (y, cb, cr) shaped as the 'coef' mode gives."""
  b = dense.shape[0]
  yb, cbn, _ = _geometry(height, width)
  y = dense[:, :yb * 64].reshape(b, height // 8, width // 8, 64)
  cb = dense[:, yb * 64:(yb + cbn) * 64].reshape(b, height // 16,
                                                 width // 16, 64)
  cr = dense[:, (yb + cbn) * 64:].reshape(b, height // 16, width // 16, 64)
  return y, cb, cr


def _scatter(pos: torch.Tensor, values: torch.Tensor,
             total: int) -> torch.Tensor:
  """int32 [B, total]: ``values`` added at the cursor positions ``pos``
  (int64). A row with no entries keeps its cursor at -1: those go to a
  spill column past the end, which is cut off (JAX's ``mode='drop'``)."""
  pos = torch.where(pos < 0, torch.full_like(pos, total), pos)
  dense = torch.zeros((pos.shape[0], total + 1), dtype=torch.int32,
                      device=pos.device)
  dense.scatter_add_(1, pos, values.to(torch.int32))
  return dense[:, :total]


def unpack_sparse_coefficients(sd: torch.Tensor, sv: torch.Tensor,
                               height: int, width: int):
  """Sparse (delta, value) entry streams -> dense coefficient planes.

  The inverse of the loader's 'coef_sparse' packing: each entry advances a
  cursor through the flat coefficient space [y | cb | cr] by ``sd``
  positions and adds ``sv`` there. Skip entries (255, 0), value
  continuations (0, piece) and tail padding (0, 0) all fall out of the
  same cumsum and scatter-add, summed in int32 and cast to int16 at the
  end (JAX's int16 sums, modulo 2^16 alike).

  Args:
    sd: [B, C] uint8 position deltas.
    sv: [B, C] int8 value pieces.
    height, width: frame geometry (divisible by 16).

  Returns: (y, cb, cr) int16, shaped as the 'coef' mode's planes.
  """
  _, _, total = _geometry(height, width)
  pos = torch.cumsum(sd.to(torch.int64), dim=1) - 1
  dense = _scatter(pos, sv, total).to(torch.int16)
  return _split_planes(dense, height, width)


def unpack_packed_coefficients(pw: torch.Tensor, se: torch.Tensor,
                               dcn: torch.Tensor, height: int, width: int):
  """Packed wire streams -> dense coefficient planes (bit-exact).

  The inverse of the loader's 'coef_packed' encoding (record_loader.cc,
  decode_jpeg_coef_packed). Three streams a frame:

    * ``pw`` [B, C] uint8: the AC nibble stream: high nibble the position
      gap, low nibble the value code (1..7 -> +v, 9..15 -> v-16, 8 ->
      escape, 0 with a gap -> skip gap*16, 0x00 -> padding).
    * ``se`` [B, E] int16: escape values, a row's DC escapes first (frame
      order), then its AC escapes (stream order).
    * ``dcn`` [B, blocks/2] uint8: a DC-delta nibble a block, two a byte
      low first; code 8 escapes to ``se``; the chain starts at 0 and is
      undone with one cumsum over the blocks.

  Returns: (y, cb, cr) int16, shaped as the 'coef' mode's planes.
  """
  b = pw.shape[0]
  _, _, total = _geometry(height, width)
  nblocks = total // 64

  d4 = (pw >> 4).to(torch.int32)
  v4 = (pw & 15).to(torch.int32)
  is_esc = v4 == 8
  is_skip = (v4 == 0) & (d4 > 0)
  delta = torch.where(is_skip, d4 << 4, d4)
  vnib = torch.where(v4 < 8, v4, v4 - 16)

  # The DC-delta plane -> a code a block (low nibble first).
  lo = (dcn & 15).to(torch.int32)
  hi = (dcn >> 4).to(torch.int32)
  codes = torch.stack([lo, hi], dim=2).reshape(b, nblocks)
  dmark = codes == 8
  dnib = torch.where(codes < 8, codes, codes - 16)

  # Escape gathers: [0, DC escapes) of a row are its DC escapes, the rest
  # its AC escapes.
  n_esc = se.shape[1]
  dce_idx = torch.cumsum(dmark.to(torch.int64), dim=1) - 1
  dce = torch.gather(se, 1, dce_idx.clamp(0, n_esc - 1))
  n_dc_esc = dmark.to(torch.int64).sum(dim=1, keepdim=True)
  ace_idx = n_dc_esc + torch.cumsum(is_esc.to(torch.int64), dim=1) - 1
  ace = torch.gather(se, 1, ace_idx.clamp(0, n_esc - 1))

  val = torch.where(is_esc, ace.to(torch.int32),
                    torch.where(is_skip, torch.zeros_like(vnib), vnib))
  pos = torch.cumsum(delta.to(torch.int64), dim=1) - 1
  dense = _scatter(pos, val, total).reshape(b, nblocks, 64)

  dcd = torch.where(dmark, dce.to(torch.int32), dnib)
  dense[:, :, 0] += torch.cumsum(dcd, dim=1, dtype=torch.int32)
  return _split_planes(dense.reshape(b, total).to(torch.int16), height,
                       width)


def unpack_sparse_features(features: Dict[str, torch.Tensor],
                           image_shapes: Dict[str, Tuple[int, int]]):
  """Replaces ``key/{sd, sv, n}`` groups with dense ``key/{y, cb, cr}``
  (``image_shapes``: key -> (height, width)); the ``key/qt`` tables pass
  through: the 'coef' mode's features, which ``decode_coef_features``
  takes."""
  for key, (height, width) in image_shapes.items():
    sd = features.pop(key + '/sd')
    sv = features.pop(key + '/sv')
    features.pop(key + '/n', None)
    features[key + '/y'], features[key + '/cb'], features[key + '/cr'] = (
        unpack_sparse_coefficients(sd, sv, height, width))
  return features


def unpack_packed_features(features: Dict[str, torch.Tensor],
                           image_shapes: Dict[str, Tuple[int, int]]):
  """Replaces ``key/{pw, se, dcn}`` groups with dense ``key/{y, cb, cr}``
  and broadcasts the batch's one ``[1, 3, 64]`` table to every frame: the
  'coef' mode's features."""
  for key, (height, width) in image_shapes.items():
    pw = features.pop(key + '/pw')
    se = features.pop(key + '/se')
    dcn = features.pop(key + '/dcn')
    y, cb, cr = unpack_packed_coefficients(pw, se, dcn, height, width)
    features[key + '/y'], features[key + '/cb'], features[key + '/cr'] = (
        y, cb, cr)
    qt = features[key + '/qt']
    if qt.shape[0] != y.shape[0]:
      features[key + '/qt'] = qt[:1].expand((y.shape[0],) +
                                            tuple(qt.shape[1:]))
  return features


def decode_coef_features(features: Dict[str, torch.Tensor],
                         image_keys: Iterable[str],
                         dtype: torch.dtype = torch.uint8):
  """Replaces ``key/{y, cb, cr, qt}`` groups with the decoded ``key``
  frames."""
  for key in image_keys:
    y = features.pop(key + '/y')
    cb = features.pop(key + '/cb')
    cr = features.pop(key + '/cr')
    qt = features.pop(key + '/qt')
    features[key] = decode_jpeg_coefficients(y, cb, cr, qt, dtype=dtype)
  return features
