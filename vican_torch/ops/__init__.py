"""Batched tensor ops of the port."""
