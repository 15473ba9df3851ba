"""Evaluation metrics and suites (port of ``photon_tpu/evaluation``)."""
