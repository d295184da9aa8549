"""Topology constructions and mixing utilities (numpy copies of
``repro/core/graphs.py`` and ``repro/core/mixing.py``)."""
