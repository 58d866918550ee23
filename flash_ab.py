#!/usr/bin/env python3
"""A/B of the flash forward kernels, K4 and K6, between this checkout and
another, on one CUDA card.

    python3 flash_ab.py OTHER_CHECKOUT

OTHER_CHECKOUT is another tree of this repository (say the parent commit,
unpacked with ``git archive`` into the git-ignored ``.archive/``). Both
builds of K4 (``csrc/flash_attention_fwd.cu``) and K6
(``csrc/flash_attention_carry.cu``) are compiled with this checkout's nvcc
flags and called through this checkout's wrappers, whose C signatures they
share. On the same inputs the script reports:

  * K4's O and LSE from the two builds at ``chip_smoke.py``'s K4 cases (the
    served [1, 4096, 8, 64] causal, [2, 200, 3, 128] causal and [3, 72, 2,
    64] full, each in float32 and bfloat16, and [8, 4096, 8, 64] causal in
    float32): in float32 bit for bit equal or not; in bfloat16 each build's
    largest error from the plain version;
  * K6's o, m and l from each build against its plain version at [8, 4096,
    8, 64] causal, offsets (0, 0), from an empty state, in float32 and
    bfloat16;
  * K4's time at the served and the training shape and K6's at [8, 4096,
    8, 64] causal at offsets (0, 0) and at the 4-rank hop [8, 1024, 8, 64]
    (diagonal: offsets 1024/1024; full: 2048/0), each in float32 and
    bfloat16, medians of 30 CUDA-event-timed calls as ``chip_smoke.py``
    times them, in turns other, this, this, other;
  * each build's SASS counts (HMMA, LDS, integer instructions), all
    functions of a library together.

It ends with one JSON line of these numbers and the card's name and power
limit. Exits non-zero without a card.
"""

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

NAMES = ('flash_attention_fwd', 'flash_attention_carry')


def build_other(other, name, kernels):
  """Compiles ``name`` from the other checkout's csrc; returns the library
  path and its loaded (function, error string) pair."""
  out_dir = Path(other) / '_ab_build'
  out_dir.mkdir(exist_ok=True)
  library = out_dir / '{}.so'.format(name)
  source = Path(other) / 'tensor2robot_tpu_torch' / 'csrc' / '{}.cu'.format(
      name)
  subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, '-o', str(library),
                  str(source)], check=True, capture_output=True, text=True)
  lib = ctypes.CDLL(str(library))
  symbol, argtypes = kernels.KERNELS[name]
  function = getattr(lib, symbol)
  function.argtypes = argtypes
  function.restype = ctypes.c_int
  lib.t2r_error_string.argtypes = [ctypes.c_int]
  lib.t2r_error_string.restype = ctypes.c_char_p
  return library, (function, lib.t2r_error_string)


def main():
  if not torch.cuda.is_available() or len(sys.argv) != 2:
    print('flash_ab: needs a CUDA card and one argument, the other '
          'checkout.', file=sys.stderr)
    return 1
  sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
  import chip_smoke
  from tensor2robot_tpu_torch import kernels
  from tensor2robot_tpu_torch.parallel import flash_attention as fa

  torch.backends.cuda.matmul.allow_tf32 = False
  other_dir = sys.argv[1]
  kernels.build(NAMES)
  builds = {'this': {}, 'other': {}}
  libraries = {'this': {}, 'other': {}}
  for name in NAMES:
    builds['this'][name] = kernels._function(name)
    libraries['this'][name] = kernels.library_path(name)
    libraries['other'][name], builds['other'][name] = build_other(
        other_dir, name, kernels)

  def use(which):
    for name in NAMES:
      kernels._functions[name] = builds[which][name]

  device = torch.device('cuda')
  gen = torch.Generator(device=device).manual_seed(0)
  result = {'smi': chip_smoke.smi_line()}

  # K4's bits, build against build.
  cases = [(1, 4096, 8, 64, True), (2, 200, 3, 128, True),
           (3, 72, 2, 64, False)]
  equal = []
  for b, length, heads, dim, causal in cases:
    for dtype in (torch.float32, torch.bfloat16):
      qkv = torch.randn((b, length, heads, 3, dim), device=device,
                        generator=gen).to(dtype)
      q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
      outs = {}
      for which in ('other', 'this'):
        use(which)
        outs[which] = fa.flash_attention_forward(q, k, v, causal,
                                                 dim ** -0.5)
      torch.cuda.synchronize()
      shape = '[{},{},{},{}] {} {}'.format(
          b, length, heads, dim, 'causal' if causal else 'full',
          str(dtype).split('.')[-1])
      if dtype == torch.bfloat16:
        want = fa.flash_attention_plain_blhd(q, k, v, causal, dim ** -0.5)
        errs = {which: [chip_smoke.max_abs_err(x, y) for x, y in
                        zip(outs[which], want)] for which in outs}
        result.setdefault('k4_bf16_err', {})[shape] = errs
        print('K4 {}: |dO|, |dLSE| from the plain version: other {}, this '
              '{}'.format(shape, errs['other'], errs['this']))
        continue
      same = all(torch.equal(x, y) for x, y in zip(outs['other'],
                                                    outs['this']))
      equal.append(same)
      print('K4 {}: O and LSE bit-equal between the builds: {}'.format(
          shape, same))
  qkv = torch.randn((8, 4096, 8, 3, 64), device=device, generator=gen)
  q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
  outs = {}
  for which in ('other', 'this'):
    use(which)
    outs[which] = fa.flash_attention_forward(q, k, v, True, 0.125)
  torch.cuda.synchronize()
  same = all(torch.equal(x, y) for x, y in zip(outs['other'], outs['this']))
  equal.append(same)
  print('K4 [8,4096,8,64] causal float32: O and LSE bit-equal between the '
        'builds: {}'.format(same))
  result['k4_bit_equal'] = all(equal)
  del outs

  # K6 against its plain version, each build.
  state = chip_smoke.carry_state(8, 8, 4096, 64, device)
  result['k6_rel_err'] = {}
  for dtype in (torch.float32, torch.bfloat16):
    name = str(dtype).split('.')[-1]
    for which in ('other', 'this'):
      use(which)
      rel, _, _ = chip_smoke.carry_errors(q.to(dtype), k.to(dtype),
                                          v.to(dtype), state, 0, 0, True)
      result['k6_rel_err'][name, which] = rel
      print('K6 [8,4096,8,64] causal (0, 0) {}, {} build: o, m, l within '
            '{:.3g} of their max of the plain version'.format(name, which,
                                                               rel))
  result['k6_rel_err'] = {'{} {}'.format(*key): rel for key, rel in
                          result['k6_rel_err'].items()}
  del qkv, q, k, v, state

  # Times, in turns other, this, this, other.
  def k4(b, dtype):
    x = torch.randn((b, 4096, 8, 3, 64), device=device,
                    generator=gen).to(dtype)
    return lambda: fa.flash_attention(x[..., 0, :], x[..., 1, :],
                                      x[..., 2, :], causal=True)

  def k6(b, length, q_offset, k_offset, dtype):
    x = torch.randn((b, length, 8, 3, 64), device=device,
                    generator=gen).to(dtype)
    st = chip_smoke.carry_state(b, 8, length, 64, device)
    return lambda: fa.flash_attention_carry(
        x[..., 0, :], x[..., 1, :], x[..., 2, :], *st, q_offset, k_offset,
        True, 0.125)

  timings = {}
  for dtype in (torch.float32, torch.bfloat16):
    name = str(dtype).split('.')[-1]
    timings.update({
        'K4 served [1,4096,8,64] ' + name: k4(1, dtype),
        'K4 training [8,4096,8,64] ' + name: k4(8, dtype),
        'K6 [8,4096,8,64] (0, 0) ' + name: k6(8, 4096, 0, 0, dtype),
        'K6 hop diagonal [8,1024,8,64] ' + name: k6(8, 1024, 1024, 1024,
                                                    dtype),
        'K6 hop full [8,1024,8,64] ' + name: k6(8, 1024, 2048, 0, dtype)})
  result['ms'] = {}
  for label, fn in timings.items():
    got = {'other': [], 'this': []}
    for which in ('other', 'this', 'this', 'other'):
      use(which)
      got[which].append(chip_smoke.median_ms(fn))
    result['ms'][label] = got
    print('{}: other {} ms, this {} ms (turns other, this, this, other); '
          'this / other {:.4f}'.format(
              label, got['other'], got['this'],
              sum(got['this']) / sum(got['other'])))
  use('this')

  result['sass'] = {which: {name: chip_smoke.sass_mix(name, libraries[which][
      name]) for name in NAMES} for which in ('other', 'this')}
  for which in ('other', 'this'):
    print('SASS, {} build: {}'.format(which, result['sass'][which]))
  print(result['smi'])
  print(json.dumps(result))
  return 0


if __name__ == '__main__':
  sys.exit(main())
