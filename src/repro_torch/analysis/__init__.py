"""Analytic cost models (port of ``repro/analysis``)."""
