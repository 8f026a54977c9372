"""Experiment tracking sinks."""
