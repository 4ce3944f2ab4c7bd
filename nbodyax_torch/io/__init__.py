"""Checkpoint files (``checkpoint``)."""
