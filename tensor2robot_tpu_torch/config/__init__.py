"""The port's configuration system: gin-file bindings for its
configurables (the JAX package's ``config/``), used as gin is:

    from tensor2robot_tpu_torch import config
    config.register_framework_configurables()
    config.parse_config_files_and_bindings(['train_qtopt.gin'], bindings)
    config.check_configurables()
    train_eval_model = config.get_configurable('train_eval_model')
    results = train_eval_model(model_dir='/tmp/run')
"""

from tensor2robot_tpu_torch.config.ginlike import (
    ConfigError,
    ConfigurableReference,
    add_config_file_search_path,
    bind_parameter,
    check_configurables,
    clear_config,
    config_str,
    configurable,
    external_configurable,
    get_configurable,
    operative_config_str,
    parse_config,
    parse_config_files_and_bindings,
    query_parameter,
)


def register_framework_configurables() -> None:
  """Registers the port's configurables under the JAX names (once)."""
  from tensor2robot_tpu_torch.config import registry
  registry.register_all()


__all__ = [
    'ConfigError',
    'ConfigurableReference',
    'add_config_file_search_path',
    'bind_parameter',
    'check_configurables',
    'clear_config',
    'config_str',
    'configurable',
    'external_configurable',
    'get_configurable',
    'operative_config_str',
    'parse_config',
    'parse_config_files_and_bindings',
    'query_parameter',
    'register_framework_configurables',
]
