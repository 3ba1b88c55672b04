"""Checkpoint conversion, logging and device selection."""
