"""Failure vocabulary of the port (from ``photon_tpu/resilience``)."""
