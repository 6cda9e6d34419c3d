"""The configuration composer of the segment CLI (a copy of the JAX
package's ``config`` module's pieces that the CLI uses)."""

from .config import (
    MISSING,
    Config,
    MissingMandatoryValue,
    compose,
    load_config,
    merge,
    resolve,
    to_plain,
)

__all__ = [
    "MISSING",
    "Config",
    "MissingMandatoryValue",
    "compose",
    "load_config",
    "merge",
    "resolve",
    "to_plain",
]
