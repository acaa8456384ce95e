"""Sampler cores of the port."""
