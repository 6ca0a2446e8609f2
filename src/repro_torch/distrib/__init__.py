"""Distributed-protocol helpers of the port (mirrors repro.distrib)."""
