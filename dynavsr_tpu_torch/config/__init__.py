"""YAML test configs."""
