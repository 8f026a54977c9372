"""Rendering of prototype evidence."""
