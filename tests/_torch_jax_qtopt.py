"""Imports the JAX package's qtopt modules, and the modules that import
them, for the port's tests.

``research/qtopt/networks.py`` registers a vmap rule behind an ``in`` test
that jax 0.9's batching proxy does not answer. For the import only, the
proxy answers ``in`` from the table it fronts; afterwards the proxy is as
it was, and every module of the JAX package that the import added leaves
``sys.modules`` again (with its attribute on its parent package), so that
later imports elsewhere see the package as before::

    with jax_qtopt_modules('research.qtopt.grasping_sim', 'rl.offpolicy') \\
        as ref:
      ref.grasping_sim.SimGraspingEnv(...)

or, for a module-scoped fixture, ``yield from jax_qtopt_fixture(...)``.
"""

import contextlib
import importlib
import sys
import types

_PACKAGE = 'tensor2robot_tpu'


def _jax_package_modules():
  return {name for name in sys.modules
          if name == _PACKAGE or name.startswith(_PACKAGE + '.')}


@contextlib.contextmanager
def jax_qtopt_modules(*names):
  """The JAX package's modules ``tensor2robot_tpu.<name>`` for each name,
  as attributes of the namespace yielded (by their last component)."""
  from jax._src.interpreters import batching

  before = _jax_package_modules()
  proxy = batching.PrimitiveBatchersProxy
  shimmed = not hasattr(proxy, '__contains__')
  if shimmed:
    proxy.__contains__ = (
        lambda self, prim: prim in batching.fancy_primitive_batchers)
  try:
    modules = {name.rsplit('.', 1)[-1]: importlib.import_module(
        _PACKAGE + '.' + name) for name in names}
  finally:
    if shimmed:
      del proxy.__contains__
  try:
    yield types.SimpleNamespace(**modules)
  finally:
    for name in sorted(_jax_package_modules() - before, reverse=True):
      del sys.modules[name]
      parent, _, child = name.rpartition('.')
      if parent in sys.modules:
        vars(sys.modules[parent]).pop(child, None)


def jax_qtopt_fixture(*names):
  """A generator for a pytest fixture: the namespace of
  ``jax_qtopt_modules(*names)`` for the fixture's scope."""
  with jax_qtopt_modules(*names) as modules:
    yield modules
