"""Numeric ops of the port: the pure functions (``functional``), the
units built on them, attention, transformer and the hand-written Hopper
kernels."""
