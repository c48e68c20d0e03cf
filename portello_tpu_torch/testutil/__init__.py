"""Jax-free test helpers."""
