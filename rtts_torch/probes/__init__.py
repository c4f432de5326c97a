"""Measurement probes of the port, each runnable with ``python -m``."""
