"""Utilities: device resolution."""
