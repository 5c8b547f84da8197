"""Frozen copies of the NumPy control plane (``core``, ``data``)."""
