"""Layers written against the tap collector."""
