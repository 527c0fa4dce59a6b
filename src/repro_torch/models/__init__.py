"""Model code of the port: layers, the xLSTM blocks and the assembly."""

from .model import Model  # noqa: F401
