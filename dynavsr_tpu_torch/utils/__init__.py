"""Experiment utilities (logger, directories, seeds) and the metrics writer."""
