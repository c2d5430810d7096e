from .configuration import Configuration, ConfigurationError, load_configuration
from .schema import SCHEMA, Field, schema_documentation

__all__ = [
    "Configuration",
    "ConfigurationError",
    "load_configuration",
    "SCHEMA",
    "Field",
    "schema_documentation",
]
