"""Core SPDC algorithms of the port (mirrors repro.core)."""
