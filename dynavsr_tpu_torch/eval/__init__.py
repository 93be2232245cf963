"""Metrics, image conversion, clip scoring."""
