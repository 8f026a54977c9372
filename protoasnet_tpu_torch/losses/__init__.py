"""The loss library (``losses.py``) and the config-driven bundle."""
