"""Experiment tools that drive the port's entry points end to end."""
