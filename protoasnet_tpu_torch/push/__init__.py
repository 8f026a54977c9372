"""Prototype push: project each prototype onto its nearest training ROI."""
