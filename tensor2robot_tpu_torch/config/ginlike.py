"""A gin-syntax configuration engine with no dependencies: the port's own
copy of the JAX package's ``config/ginlike.py``, with the same syntax, API
and error texts, so that the gins drive the port's trainer as they drive
the JAX one:

  * ``name.param = value`` bindings, with dotted names matched by suffix
    (``DefaultRecordInputGenerator`` == ``data.DefaultRecordInputGenerator``)
  * explicit scopes: ``train_input_generator/Cls.param = ...`` applied via
    ``@train_input_generator/Cls()`` references
  * macros: ``TRAIN_DATA = '/path*'`` / ``%TRAIN_DATA``
  * configurable references ``@name`` (the callable itself) and ``@name()``
    (called each time the binding is injected)
  * ``include 'other.gin'`` (relative to the including file or the
    configured search paths)
  * python-literal values incl. tuples/lists/dicts/scientific notation
  * ``operative_config_str()``: what was actually consumed, for the
    config snapshot written into model_dir.

API as gin's: ``configurable``, ``external_configurable``,
``parse_config``, ``parse_config_files_and_bindings``, ``clear_config``,
``query_parameter``, ``bind_parameter``, ``config_str``,
``operative_config_str``. The port
adds ``check_configurables``: every name that the parsed bindings bind or
reference must be registered, so that a gin naming a configurable the port
lacks fails before anything runs instead of being skipped.
"""

from __future__ import annotations

import ast
import functools
import inspect
import os
import re
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

_REGISTRY: Dict[str, Callable] = {}
_BINDINGS: Dict[Tuple[str, str, str], Any] = {}  # (scope, name, param) -> raw
_MACROS: Dict[str, Any] = {}
_OPERATIVE: Dict[Tuple[str, str, str], Any] = {}
_SEARCH_PATHS: List[str] = ['']
_LOCK = threading.RLock()
_SCOPE_STACK = threading.local()


class ConfigError(Exception):
  pass


def add_config_file_search_path(path: str) -> None:
  if path not in _SEARCH_PATHS:
    _SEARCH_PATHS.append(path)


def clear_config(clear_registry: bool = False) -> None:
  with _LOCK:
    _BINDINGS.clear()
    _MACROS.clear()
    _OPERATIVE.clear()
    if clear_registry:
      _REGISTRY.clear()


def _current_scopes() -> List[str]:
  return getattr(_SCOPE_STACK, 'scopes', [])


class _ScopeContext:
  def __init__(self, scope: str):
    self._scope = scope

  def __enter__(self):
    scopes = getattr(_SCOPE_STACK, 'scopes', [])
    _SCOPE_STACK.scopes = scopes + [self._scope]
    return self

  def __exit__(self, *exc):
    _SCOPE_STACK.scopes = _SCOPE_STACK.scopes[:-1]
    return False


def _resolve_name(name: str) -> str:
  """Finds the registered full name matching ``name`` by dotted suffix."""
  if name in _REGISTRY:
    return name
  matches = [full for full in _REGISTRY
             if full == name or full.endswith('.' + name)]
  if len(matches) == 1:
    return matches[0]
  if not matches:
    raise ConfigError('No configurable matching {!r}.'.format(name))
  raise ConfigError('Ambiguous configurable {!r}: {}.'.format(name, matches))


class ConfigurableReference:
  """A ``@[scope/]name`` value: the configurable, with its scope attached."""

  def __init__(self, name: str, scope: str = '', evaluate: bool = False):
    self.name = name
    self.scope = scope
    self.evaluate = evaluate

  def __repr__(self):
    prefix = self.scope + '/' if self.scope else ''
    return '@{}{}{}'.format(prefix, self.name, '()' if self.evaluate else '')

  def resolve(self):
    fn = _REGISTRY[_resolve_name(self.name)]
    if not self.scope:
      return fn

    @functools.wraps(fn)
    def scoped(*args, **kwargs):
      with _ScopeContext(self.scope):
        return fn(*args, **kwargs)

    return scoped


def _materialize(value):
  """Raw parsed value -> runtime value (resolve refs/macros, recurse)."""
  if isinstance(value, ConfigurableReference):
    fn = value.resolve()
    return fn() if value.evaluate else fn
  if isinstance(value, _MacroReference):
    if value.name not in _MACROS:
      raise ConfigError('Undefined macro %{}.'.format(value.name))
    return _materialize(_MACROS[value.name])
  if isinstance(value, list):
    return [_materialize(v) for v in value]
  if isinstance(value, tuple):
    return tuple(_materialize(v) for v in value)
  if isinstance(value, dict):
    return {k: _materialize(v) for k, v in value.items()}
  return value


class _MacroReference:
  def __init__(self, name: str):
    self.name = name

  def __repr__(self):
    return '%' + self.name


def _bindings_for(full_name: str, short_name: str) -> Dict[str, Any]:
  """Applicable bindings for a call: unscoped then active-scope overrides."""
  out: Dict[str, Any] = {}
  keys: Dict[str, Tuple[str, str, str]] = {}
  with _LOCK:
    for (scope, name, param), raw in _BINDINGS.items():
      if name not in (full_name, short_name):
        continue
      if scope == '':
        if param not in out:
          out[param] = raw
          keys[param] = (scope, name, param)
    for active in _current_scopes():
      for (scope, name, param), raw in _BINDINGS.items():
        if scope == active and name in (full_name, short_name):
          out[param] = raw
          keys[param] = (scope, name, param)
  return {param: (raw, keys[param]) for param, raw in out.items()}


def _make_configurable(fn: Callable, full_name: str) -> Callable:
  short_name = full_name.rsplit('.', 1)[-1]
  if inspect.isclass(fn):
    signature_target = fn.__init__
  else:
    signature_target = fn
  try:
    signature = inspect.signature(signature_target)
    has_var_kwargs = any(
        p.kind == inspect.Parameter.VAR_KEYWORD
        for p in signature.parameters.values())
    accepted = {p.name for p in signature.parameters.values()
                if p.kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                              inspect.Parameter.KEYWORD_ONLY)}
  except (TypeError, ValueError):
    signature, has_var_kwargs, accepted = None, True, set()

  @functools.wraps(fn)
  def wrapper(*args, **kwargs):
    injected = {}
    for param, (raw, key) in _bindings_for(full_name, short_name).items():
      if param in kwargs:
        continue
      if not has_var_kwargs and param not in accepted:
        raise ConfigError(
            '{} got an unknown configured parameter {!r}.'.format(
                full_name, param))
      value = _materialize(raw)
      injected[param] = value
      with _LOCK:
        _OPERATIVE[key] = value
    # Positionally-passed args win over bindings (gin semantics).
    if signature is not None and args:
      positional = [p.name for p in signature.parameters.values()
                    if p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                                  inspect.Parameter.POSITIONAL_OR_KEYWORD)]
      if inspect.isclass(fn) and positional and positional[0] == 'self':
        positional = positional[1:]
      for name in positional[:len(args)]:
        injected.pop(name, None)
    kwargs = {**injected, **kwargs}
    return fn(*args, **kwargs)

  wrapper.__wrapped_configurable__ = fn
  return wrapper


def configurable(name_or_fn=None, module: Optional[str] = None):
  """Decorator registering a function/class as configurable (gin API)."""

  def _register(fn, name=None):
    base = name or fn.__name__
    full_name = '{}.{}'.format(module, base) if module else base
    wrapped = _make_configurable(fn, full_name)
    with _LOCK:
      _REGISTRY[full_name] = wrapped
    return wrapped

  if callable(name_or_fn):
    return _register(name_or_fn)

  def decorator(fn):
    return _register(fn, name=name_or_fn)

  return decorator


def external_configurable(fn: Callable, name: Optional[str] = None,
                          module: Optional[str] = None) -> Callable:
  """Registers library callables without modifying them."""
  base = name or fn.__name__
  full_name = '{}.{}'.format(module, base) if module else base
  wrapped = _make_configurable(fn, full_name)
  with _LOCK:
    _REGISTRY[full_name] = wrapped
  return wrapped


def get_configurable(name: str) -> Callable:
  return _REGISTRY[_resolve_name(name)]


# -- parsing ------------------------------------------------------------------

_BINDING_RE = re.compile(r'^(?:(?P<scope>[\w./]+)/)?(?P<name>[\w.]+)\.'
                         r'(?P<param>\w+)\s*=\s*(?P<value>.+)$', re.S)
_MACRO_RE = re.compile(r'^(?P<name>\w+)\s*=\s*(?P<value>.+)$', re.S)
_INCLUDE_RE = re.compile(r'''^include\s+['"](?P<path>[^'"]+)['"]$''')


class _ValueParser:
  """Recursive-descent parser for gin value expressions."""

  def __init__(self, text: str):
    self.text = text
    self.pos = 0

  def parse(self):
    value = self._parse_value()
    self._skip_ws()
    if self.pos != len(self.text):
      raise ConfigError('Trailing characters in value: {!r}'.format(
          self.text[self.pos:]))
    return value

  def _skip_ws(self):
    while self.pos < len(self.text) and self.text[self.pos] in ' \t\n\r':
      self.pos += 1

  def _parse_value(self):
    self._skip_ws()
    if self.pos >= len(self.text):
      raise ConfigError('Empty value.')
    ch = self.text[self.pos]
    if ch == '@':
      return self._parse_reference()
    if ch == '%':
      self.pos += 1
      match = re.match(r'[\w.]+', self.text[self.pos:])
      if not match:
        raise ConfigError('Bad macro reference in {!r}.'.format(self.text))
      self.pos += match.end()
      return _MacroReference(match.group(0))
    if ch == '[':
      return self._parse_sequence(']', list)
    if ch == '(':
      return self._parse_sequence(')', tuple)
    if ch == '{':
      return self._parse_dict()
    return self._parse_literal()

  def _parse_reference(self):
    self.pos += 1  # consume '@'
    match = re.match(r'(?:(?P<scope>[\w./]+)/)?(?P<name>[\w.]+)',
                     self.text[self.pos:])
    if not match:
      raise ConfigError('Bad reference in {!r}.'.format(self.text))
    self.pos += match.end()
    evaluate = False
    if self.text[self.pos:self.pos + 2] == '()':
      evaluate = True
      self.pos += 2
    return ConfigurableReference(match.group('name'),
                                 match.group('scope') or '', evaluate)

  def _parse_sequence(self, closing: str, factory):
    self.pos += 1
    items = []
    while True:
      self._skip_ws()
      if self.pos >= len(self.text):
        raise ConfigError('Unterminated sequence in {!r}.'.format(self.text))
      if self.text[self.pos] == closing:
        self.pos += 1
        return factory(items)
      items.append(self._parse_value())
      self._skip_ws()
      if self.pos < len(self.text) and self.text[self.pos] == ',':
        self.pos += 1

  def _parse_dict(self):
    self.pos += 1
    out = {}
    while True:
      self._skip_ws()
      if self.pos >= len(self.text):
        raise ConfigError('Unterminated dict in {!r}.'.format(self.text))
      if self.text[self.pos] == '}':
        self.pos += 1
        return out
      key = self._parse_value()
      self._skip_ws()
      if self.text[self.pos] != ':':
        raise ConfigError('Expected : in dict {!r}.'.format(self.text))
      self.pos += 1
      out[key] = self._parse_value()
      self._skip_ws()
      if self.pos < len(self.text) and self.text[self.pos] == ',':
        self.pos += 1

  def _parse_literal(self):
    rest = self.text[self.pos:]
    # Strings: delegate to ast for proper escape handling.
    if rest[0] in '\'"':
      quote = rest[0]
      end = 1
      while end < len(rest):
        if rest[end] == '\\':
          end += 2
          continue
        if rest[end] == quote:
          break
        end += 1
      literal = rest[:end + 1]
      self.pos += end + 1
      return ast.literal_eval(literal)
    match = re.match(r'[^,\]\)\}:\s]+', rest)
    if not match:
      raise ConfigError('Bad literal in {!r}.'.format(self.text))
    token = match.group(0)
    self.pos += match.end()
    try:
      return ast.literal_eval(token)
    except (SyntaxError, ValueError):
      return token  # bare identifier -> string (gin tolerates for enums)


def _strip_comment(line: str) -> str:
  """Removes a trailing # comment, ignoring # inside quoted strings."""
  quote = None
  i = 0
  while i < len(line):
    ch = line[i]
    if quote:
      if ch == '\\':
        i += 2
        continue
      if ch == quote:
        quote = None
    elif ch in '\'"':
      quote = ch
    elif ch == '#':
      return line[:i]
    i += 1
  return line


def _logical_lines(text: str):
  """Joins continuation lines (open brackets or trailing backslash)."""
  pending = ''
  depth = 0
  for raw_line in text.splitlines():
    line = _strip_comment(raw_line).rstrip()
    if not line.strip() and not pending:
      continue
    pending = (pending + '\n' + line) if pending else line
    depth = (pending.count('[') - pending.count(']') +
             pending.count('(') - pending.count(')') +
             pending.count('{') - pending.count('}'))
    if depth > 0 or pending.endswith('\\'):
      pending = pending.rstrip('\\')
      continue
    yield pending.strip()
    pending = ''
  if pending.strip():
    yield pending.strip()


def parse_config(config: str, base_dir: str = '') -> None:
  """Parses gin-format binding text (gin.parse_config)."""
  for line in _logical_lines(config):
    include = _INCLUDE_RE.match(line)
    if include:
      _parse_file(include.group('path'), base_dir)
      continue
    binding = _BINDING_RE.match(line)
    if binding:
      raw = _ValueParser(binding.group('value')).parse()
      with _LOCK:
        _BINDINGS[(binding.group('scope') or '', binding.group('name'),
                   binding.group('param'))] = raw
      continue
    macro = _MACRO_RE.match(line)
    if macro:
      raw = _ValueParser(macro.group('value')).parse()
      with _LOCK:
        _MACROS[macro.group('name')] = raw
      continue
    raise ConfigError('Unparseable config line: {!r}'.format(line))


def _parse_file(path: str, base_dir: str = '') -> None:
  candidates = [os.path.join(base_dir, path)] if base_dir else []
  candidates += [os.path.join(p, path) for p in _SEARCH_PATHS]
  for candidate in candidates:
    if os.path.isfile(candidate):
      with open(candidate) as f:
        parse_config(f.read(), base_dir=os.path.dirname(candidate))
      return
  raise ConfigError('Config file {!r} not found (searched {}).'.format(
      path, candidates))


def parse_config_files_and_bindings(
    config_files: Optional[Sequence[str]] = None,
    bindings: Optional[Sequence[str]] = None) -> None:
  """gin.parse_config_files_and_bindings."""
  for path in config_files or []:
    _parse_file(path)
  if bindings:
    parse_config('\n'.join(bindings))


def query_parameter(binding_key: str):
  """Current value of '[scope/]name.param' (gin.query_parameter)."""
  match = _BINDING_RE.match(binding_key + ' = 0')
  if not match:
    raise ConfigError('Bad binding key {!r}.'.format(binding_key))
  key = (match.group('scope') or '', match.group('name'),
         match.group('param'))
  with _LOCK:
    if key not in _BINDINGS:
      raise ConfigError('No binding for {!r}.'.format(binding_key))
    return _materialize(_BINDINGS[key])


def bind_parameter(binding_key: str, value: Any) -> None:
  """Binds '[scope/]name.param' to ``value``, a Python object as it is
  (gin.bind_parameter): what a program builds at run time, such as a
  process group."""
  match = _BINDING_RE.match(binding_key + ' = 0')
  if not match:
    raise ConfigError('Bad binding key {!r}.'.format(binding_key))
  with _LOCK:
    _BINDINGS[(match.group('scope') or '', match.group('name'),
               match.group('param'))] = value


def _format(value) -> str:
  return repr(value)


def config_str() -> str:
  """All current bindings, as re-parseable text."""
  lines = []
  with _LOCK:
    for name, value in sorted(_MACROS.items()):
      lines.append('{} = {}'.format(name, _format(value)))
    for (scope, name, param), raw in sorted(_BINDINGS.items()):
      prefix = scope + '/' if scope else ''
      lines.append('{}{}.{} = {}'.format(prefix, name, param, _format(raw)))
  return '\n'.join(lines) + '\n'


def operative_config_str() -> str:
  """Bindings actually consumed by configurable calls so far."""
  lines = []
  with _LOCK:
    for (scope, name, param), value in sorted(_OPERATIVE.items()):
      prefix = scope + '/' if scope else ''
      lines.append('{}{}.{} = {}'.format(prefix, name, param,
                                         _format(value)))
  return '\n'.join(lines) + '\n'


def _references(value):
  if isinstance(value, ConfigurableReference):
    yield value.name
  elif isinstance(value, (list, tuple)):
    for item in value:
      yield from _references(item)
  elif isinstance(value, dict):
    for item in value.values():
      yield from _references(item)


def check_configurables() -> None:
  """Raises ``ConfigError`` (the text ``_resolve_name`` raises) for the
  first name that a binding binds or a value references and that no
  registered configurable matches."""
  with _LOCK:
    names = [name for (_, name, _) in sorted(_BINDINGS)]
    for raw in list(_MACROS.values()) + list(_BINDINGS.values()):
      names.extend(_references(raw))
  for name in names:
    _resolve_name(name)
