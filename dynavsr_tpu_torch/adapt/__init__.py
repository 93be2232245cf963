"""Test-time adaptation (the DynaVSR product loop)."""
