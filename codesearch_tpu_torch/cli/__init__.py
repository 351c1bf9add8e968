"""Command line of the port."""

from .main import main  # noqa: F401
