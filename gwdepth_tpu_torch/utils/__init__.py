"""Logging and checkpointing of the port."""
