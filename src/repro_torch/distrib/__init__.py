"""Distributed-protocol helpers of the port (mirrors repro.distrib):
verification-driven recovery (recovery.py) and rateless
straggler-adaptive dispatch with fleet health (rateless.py)."""
