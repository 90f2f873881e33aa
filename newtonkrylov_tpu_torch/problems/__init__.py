"""Test and benchmark problems (ported so far: 2-D Bratu)."""

from . import bratu2d

__all__ = ["bratu2d"]
