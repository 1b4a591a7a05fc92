"""Configurations of the port (the DPRT workload only, so far)."""
