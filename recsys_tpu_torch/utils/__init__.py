"""Utilities: device resolution, the metric sinks, the ctypes binding to
the native C++ runtime."""
