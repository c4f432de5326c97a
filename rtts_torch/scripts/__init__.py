"""Evaluation scripts of the port, each runnable with ``python -m``."""
